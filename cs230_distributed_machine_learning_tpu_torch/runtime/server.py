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
foreground. The observability routes (JAX ``server.py``) are ported: the
dashboard, the Prometheus exposition with its scrape-time refreshes, the
``torch.profiler`` capture, traces and their export, critical paths, the
agents' span ingest, cost, explain, the event firehose, alerts, autoscale
and the metrics history; and the RED and trace middleware (an
``X-Trace-Id`` request runs inside an ``http.<endpoint>`` span of that
trace, the id echoed on the reply; every request lands in
``tpuml_http_request_seconds{route,method,code}``).

The sharded control plane (JAX ``server.py``): ``--shard-index K
--num-shards N`` serve shard K behind stateless front ends (a journal of
its own under ``<journal>/shard-<K>``, the admission caps carved per
shard, ``/create_session`` honoring a front-end-minted id that hashes
here), ``--peers`` the shard directory for rebalancing; the routes
``/migrate_in``, ``/steal_candidates``, ``/steal_tasks`` and
``/peer_result``; a migrated job's routes answer ``409 {"status":
"moved", "migrated_to": k}``, which front ends turn into a cached
redirect. ``/slice_heartbeat`` and ``/slice_status`` carry the SPMD slice
watchdog of ``run_distributed`` (runtime/agent.py). ``/subscribe`` takes
the worker's mesh-slice report and answers with prewarm hints.
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

from ..obs import (
    PARENT_HEADER,
    PROFILER,
    RECORDER,
    TIMESERIES,
    TRACE_HEADER,
    TRACER,
    activate,
    compare_critical_paths,
    counter_inc,
    export_trace,
    gauge_set,
    obs_enabled,
    observe,
    refresh_route_p99,
    render_prometheus,
    span,
    timeseries_sample,
)
from ..utils.logging import get_logger
from ..utils.serialization import json_safe
from .coordinator import Coordinator

logger = get_logger("tpuml.server")

#: Self-contained observability page (no external assets — fleets run
#: without egress). Tables over the JSON endpoints, 2 s auto-refresh.
_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpuml coordinator</title>
<style>
 body{font:14px/1.45 system-ui,sans-serif;margin:24px;color:#1a1a1a;background:#fafafa}
 h1{font-size:18px;margin:0 0 4px} h2{font-size:15px;margin:24px 0 6px}
 table{border-collapse:collapse;width:100%;background:#fff}
 th,td{border:1px solid #ddd;padding:4px 8px;text-align:left;font-size:13px}
 th{background:#f0f0f0} .ok{color:#1a7f37} .bad{color:#b42318}
 #meta{color:#666;font-size:12px} code{background:#eee;padding:0 3px}
</style></head><body>
<h1>tpuml coordinator</h1>
<div id="meta">health: <span id="health">…</span> · refreshed <span id="ts">never</span>
 · JSON: <code>/jobs</code> <code>/workers</code> <code>/queues</code> <code>/supervisor</code>
 <code>/metrics/prom</code> <code>/metrics/history?name=</code> <code>/trace/&lt;job_id&gt;</code>
 <code>/critical_path/&lt;job_id&gt;</code> <code>/trace/&lt;job_id&gt;/export</code>
 <code>/cost/&lt;job_id&gt;</code> <code>/explain/&lt;job_id&gt;/&lt;subtask_id&gt;</code>
 <code>/curves/&lt;job_id&gt;</code> <code>/events</code> <code>/predictor/calibration</code> <code>/healthz</code>
 <code>/alerts</code> <code>/autoscale</code></div>
<h2>Jobs</h2><table id="jobs"><thead><tr><th>job</th><th>model</th><th>dataset</th>
<th>status</th><th>done</th><th>failed</th><th>pruned</th><th>diverged</th><th>total</th><th>session</th></tr></thead><tbody></tbody></table>
<h2>Learning curves (latest job)</h2>
<div id="curves" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no curves yet</div>
<h2>Latest job trace</h2>
<div id="trace" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no trace yet</div>
<h2>Critical path</h2>
<div id="critpath" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no critical path yet</div>
<h2>Latest job cost</h2>
<div id="cost" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no cost data yet</div>
<h2>Metrics history</h2>
<div id="spark" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no samples yet</div>
<h2>Perf observatory</h2>
<div id="perfspark" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no samples yet</div>
<h2>Fleet health</h2>
<div id="autoscale" style="background:#fff;border:1px solid #ddd;padding:8px;font-size:12px">no signals yet</div>
<table id="alerts"><thead></thead><tbody></tbody></table>
<h2>Flight recorder (latest events)</h2>
<table id="events"><thead></thead><tbody></tbody></table>
<h2>Workers</h2><table id="workers"><thead></thead><tbody></tbody></table>
<h2>Queues</h2><table id="queues"><thead></thead><tbody></tbody></table>
<h2>Supervised agents</h2><table id="sup"><thead></thead><tbody></tbody></table>
<script>
const get = u => fetch(u).then(r => r.ok ? r.json() : null).catch(() => null);
// quotes escaped too: esc() output lands inside attribute values (the
// trace rows' title tooltips), and attrs carry client-controlled strings
const esc = s => String(s ?? "").replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
// cell renderer: arrays (e.g. a worker's queued-subtask list) collapse to
// a count + sample, never one column per index
const cell = v => Array.isArray(v)
  ? `${v.length} queued${v.length ? ": " + v.slice(0, 3).join(", ") + (v.length > 3 ? ", …" : "") : ""}`
  : (typeof v === "object" && v ? JSON.stringify(v) : v);
function kvTable(el, obj){
  const rows = Object.entries(obj || {});
  if (!rows.length){ el.tBodies[0].innerHTML = "<tr><td>none</td></tr>"; el.tHead.innerHTML=""; return; }
  const plain = rows.every(([,v]) => typeof v !== "object" || !v || Array.isArray(v));
  const cols = plain ? null
    : [...new Set(rows.flatMap(([,v]) => Object.keys(v)))];
  el.tHead.innerHTML = plain
    ? "<tr><th>id</th><th>value</th></tr>"
    : "<tr><th>id</th>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  el.tBodies[0].innerHTML = rows.map(([k, v]) =>
    `<tr><td>${esc(k)}</td>` + (plain
      ? `<td>${esc(cell(v))}</td>`
      : cols.map(c => `<td>${esc(cell(v[c]))}</td>`).join("")) + "</tr>").join("");
}
function listTable(el, arr){
  if (!arr || !arr.length){ el.tBodies[0].innerHTML = "<tr><td>none</td></tr>"; el.tHead.innerHTML=""; return; }
  const cols = Object.keys(arr[0]);
  el.tHead.innerHTML = "<tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  el.tBodies[0].innerHTML = arr.map(r =>
    "<tr>" + cols.map(c => `<td>${esc(JSON.stringify(r[c]))}</td>`).join("") + "</tr>").join("");
}
// span-tree timeline: one row per span, bar offset/width proportional to
// [start, end] within the trace window, indented by tree depth
function renderTrace(el, data){
  if (!data || !data.spans || !data.spans.length){ el.textContent = "no trace yet"; return; }
  const t0 = Math.min(...data.spans.map(s => s.start));
  const t1 = Math.max(...data.spans.map(s => s.end));
  const total = Math.max(t1 - t0, 1e-6);
  const rows = [];
  const walk = (nodes, depth) => (nodes || []).forEach(n => {
    rows.push({n, depth}); walk(n.children, depth + 1); });
  walk(data.tree, 0);
  el.innerHTML =
    `<div style="color:#666">trace <code>${esc(data.trace_id)}</code> · ` +
    `${data.spans.length} spans · ${(total * 1000).toFixed(1)} ms</div>` +
    rows.map(({n, depth}) => {
      const off = 100 * (n.start - t0) / total;
      const w = Math.max(100 * (n.end - n.start) / total, 0.4);
      return `<div style="display:flex;align-items:center;margin:1px 0">` +
        `<span style="width:230px;padding-left:${depth * 12}px;overflow:hidden;` +
        `white-space:nowrap" title="${esc(JSON.stringify(n.attrs))}">${esc(n.name)}</span>` +
        `<span style="flex:1;position:relative;height:10px;background:#f4f4f4">` +
        `<span style="position:absolute;left:${off}%;width:${w}%;height:10px;` +
        `background:${n.attrs && n.attrs.synthesized ? "#9bb8d3" : "#4a7fb5"}"></span></span>` +
        `<span style="width:80px;text-align:right">${((n.end - n.start) * 1000).toFixed(1)} ms</span></div>`;
    }).join("");
}
// critical-path waterfall (GET /critical_path/<job_id>): one stacked bar
// tiling the job wall plus a ranked per-segment table; untraced slices
// render hatched-gray so coverage gaps are visible, not hidden
const SEG_COLORS = {
  "frontend.proxy": "#8e7cc3", "submit.http": "#6fa8dc", submit: "#4a7fb5",
  expand: "#3d6d9e", "queue.wait": "#e6b84c", place: "#c27ba0",
  "reclaim.wait": "#b42318", "executor.compile": "#93c47d",
  "executor.stage": "#76a5af", "executor.dispatch": "#45818e",
  "executor.fetch": "#6aa84f", execute: "#38761d",
  "result.ingest": "#a2c4c9", aggregate: "#674ea7", untraced: "#d9d9d9",
};
function renderCritPath(el, cp){
  if (!cp || !cp.segments || !cp.segments.length){
    el.textContent = "no critical path yet"; return; }
  const wall = Math.max(cp.wall_s, 1e-9);
  el.innerHTML =
    `<div style="color:#666">job <code>${esc(cp.job_id)}</code> · ` +
    `wall ${(cp.wall_s * 1000).toFixed(1)} ms · coverage ` +
    `${(100 * cp.coverage).toFixed(1)}% · dominant ` +
    `<b>${esc((cp.dominant || [])[0] || "")}</b>` +
    (cp.n_reclaims ? ` · <span class="bad">${esc(cp.n_reclaims)} reclaim(s)</span>` : "") +
    (cp.speculated ? ` · speculative win` : "") + `</div>` +
    `<div style="display:flex;height:18px;margin:6px 0;border:1px solid #ccc">` +
    cp.segments.map(s =>
      `<span title="${esc(s.name)} ${(s.duration_s * 1000).toFixed(1)} ms" ` +
      `style="width:${(100 * s.duration_s / wall).toFixed(3)}%;` +
      `background:${SEG_COLORS[s.name] || "#999"}"></span>`).join("") +
    `</div>` +
    `<table><thead><tr><th>segment</th><th>total</th><th>share</th></tr></thead><tbody>` +
    (cp.dominant || []).map(n =>
      `<tr><td><span style="display:inline-block;width:10px;height:10px;` +
      `background:${SEG_COLORS[n] || "#999"}"></span> ${esc(n)}</td>` +
      `<td>${((cp.totals[n] || 0) * 1000).toFixed(1)} ms</td>` +
      `<td>${(100 * (cp.totals[n] || 0) / wall).toFixed(1)}%</td></tr>`).join("") +
    `</tbody></table>`;
}
// SI-ish magnitude formatter for FLOP/byte counts
const fmt = n => n == null ? "\\u2013"
  : n >= 1e12 ? (n / 1e12).toFixed(2) + " T"
  : n >= 1e9 ? (n / 1e9).toFixed(2) + " G"
  : n >= 1e6 ? (n / 1e6).toFixed(2) + " M"
  : String(Math.round(n));
const pct = v => v == null ? "\\u2013" : (100 * v).toFixed(1) + "%";
// per-job device cost report (GET /cost/<job_id>): totals line + one row
// per executed (dataset, model) group
function renderCost(el, c){
  if (!c || !c.n_groups){ el.textContent = "no cost data yet"; return; }
  el.innerHTML =
    `<div style="color:#666">job <code>${esc(c.job_id)}</code> · ` +
    `${(c.device_seconds || 0).toFixed(3)} device-s · ` +
    `model FLOPs ${fmt(c.model_flops)} · bytes ${fmt(c.bytes_accessed)} · ` +
    `MFU ${c.mfu == null ? "n/a" : pct(c.mfu)}</div>` +
    `<table><thead><tr><th>model</th><th>dataset</th><th>trials</th>` +
    `<th>device-s</th><th>FLOPs</th><th>bytes</th><th>MFU</th>` +
    `<th>HBM peak</th></tr></thead><tbody>` +
    c.groups.map(g => `<tr><td>${esc(g.model_type)}</td>` +
      `<td>${esc(g.dataset_id)}</td><td>${esc(g.n_subtasks)}</td>` +
      `<td>${(g.device_seconds || 0).toFixed(3)}</td>` +
      `<td>${fmt(g.model_flops != null ? g.model_flops : g.xla_flops)}</td>` +
      `<td>${fmt(g.bytes_accessed)}</td><td>${pct(g.mfu)}</td>` +
      `<td>${fmt(g.hbm_peak_bytes)}</td></tr>`).join("") +
    `</tbody></table>`;
}
// sparkline panels over GET /metrics/history (the embedded time-series
// ring, obs/timeseries.py): per-worker queue depth and breaker state,
// the retry RATE derived from the counter's samples, and MFU per model
const SPARKS = [
  {name: "tpuml_worker_queue_depth", title: "queue depth", mode: "raw"},
  {name: "tpuml_subtasks_retried_total", title: "retries/s", mode: "rate"},
  {name: "tpuml_worker_breaker_state", title: "breaker state", mode: "raw"},
  {name: "tpuml_executor_mfu", title: "MFU", mode: "raw"},
];
// perf-observatory panel (docs/OBSERVABILITY.md "Perf observatory"):
// per-route p99 (the derived gauge the scrape refreshes) and the
// device-seconds-per-phase RATE (fraction of wall the device pipeline
// spends staging / compiling / dispatching / fetching)
const PERF_SPARKS = [
  {name: "tpuml_http_route_p99_seconds", title: "route p99 (s)", mode: "raw"},
  {name: "tpuml_executor_device_seconds_total",
   title: "device-s/s by phase", mode: "rate"},
  {name: "tpuml_sse_lag_seconds", title: "SSE lag (s)", mode: "raw"},
];
function sparkSvg(pts){
  if (pts.length < 2) return "";
  const t0 = pts[0][0], t1 = pts[pts.length - 1][0];
  const vs = pts.map(p => p[1]);
  const vmin = Math.min(...vs, 0), vmax = Math.max(...vs);
  const W = 160, H = 26;
  const poly = pts.map(([t, v]) =>
    `${(W * (t - t0) / Math.max(t1 - t0, 1e-9)).toFixed(1)},` +
    `${(H - 2 - (H - 4) * (v - vmin) / Math.max(vmax - vmin, 1e-9)).toFixed(1)}`
  ).join(" ");
  return `<svg width="${W}" height="${H}" style="background:#f4f4f4;vertical-align:middle">` +
    `<polyline points="${poly}" fill="none" stroke="#4a7fb5" stroke-width="1.5"/></svg>`;
}
// counter samples -> per-interval rate (clamped at 0: restarts reset)
const rate = s => s.slice(1).map((p, i) =>
  [p[0], Math.max(p[1] - s[i][1], 0) / Math.max(p[0] - s[i][0], 1e-9)]);
async function renderSparks(el, sparks){
  const blocks = await Promise.all(sparks.map(async p => {
    const h = await get(`/metrics/history?name=${p.name}`);
    const series = ((h && h.series) || []).filter(s => s.samples.length > 1);
    if (!series.length) return "";
    return `<div style="margin:2px 0"><b>${esc(p.title)}</b> ` +
      series.slice(0, 8).map(s => {
        const pts = p.mode === "rate" ? rate(s.samples) : s.samples;
        if (!pts.length) return "";
        const last = pts[pts.length - 1][1];
        const lbl = Object.values(s.labels).join(",") || "total";
        return `<span style="margin-right:12px;white-space:nowrap">` +
          `${esc(lbl)} ${sparkSvg(pts)} <code>${(+last).toPrecision(3)}</code></span>`;
      }).join("") + `</div>`;
  }));
  const html = blocks.filter(Boolean).join("");
  el.innerHTML = html || "no samples yet";
}
// learning-curve panel (GET /curves/<job_id> — docs/OBSERVABILITY.md
// "Trial telemetry plane"): one sparkline per trial curve, drawn from
// the record's primary channel (loss > score > gmax), split 0. Diverged
// trials are flagged; None points (non-finite on device) are skipped.
function renderCurves(el, c){
  if (!c || !c.curves || !c.curves.length){ el.textContent = "no curves yet"; return; }
  el.innerHTML =
    `<div style="color:#666">job <code>${esc(c.job_id)}</code> · ` +
    `${c.n_curves} curves · ${c.tasks_diverged || 0} diverged</div>` +
    c.curves.slice(-10).map(e => {
      const rec = e.curve || {};
      const ch = rec.loss ? "loss" : (rec.score ? "score" : "gmax");
      const row = ((rec[ch] || [])[0] || []);
      const pts = row.map((v, i) => [i, v]).filter(p => p[1] != null && isFinite(p[1]));
      const tail = (rec.tail || [])[0];
      return `<div style="margin:2px 0;white-space:nowrap">` +
        `<code>${esc(e.subtask_id)}</code> r${esc(e.rung)} ` +
        sparkSvg(pts) + ` <b>${esc(ch)}</b>` +
        (tail == null ? "" : ` tail <code>${(+tail).toPrecision(3)}</code>`) +
        (e.diverged ? ` <span class="bad">diverged</span>` : "") + `</div>`;
    }).join("");
}
// fleet health panel (docs/OBSERVABILITY.md "Fleet health plane"):
// the derived capacity signals + per-rule alert states
function renderHealth(scaleEl, alertsEl, sc, al){
  if (sc && sc.desired_workers != null){
    const held = sc.hysteresis && sc.hysteresis.scale_down_held;
    const sig = sc.signals || {};
    scaleEl.innerHTML =
      `desired workers <b>${esc(sc.desired_workers)}</b> (live ${esc(sc.live_workers)})` +
      ` \\u00b7 desired shards <b>${esc(sc.desired_shards)}</b> (now ${esc(sc.n_shards)})` +
      (held ? ` \\u00b7 <span class="bad">scale-down held (drain)</span>` : "") +
      `<div style="color:#666">backlog ${esc(sig.backlog_seconds)} s \\u00b7 ` +
      `inflight ${esc(sig.inflight_jobs)} jobs / ${esc(sig.pending_subtasks)} subtasks \\u00b7 ` +
      `admission ${esc(((sig.admission_utilization || 0) * 100).toFixed(0))}% \\u00b7 ` +
      `p99 ${esc(sig.route_p99_s)} s \\u00b7 pressure ${esc(sig.pressure)}</div>`;
  } else scaleEl.textContent = "no signals yet";
  const rows = ((al && al.alerts) || []).map(a => ({
    rule: a.rule,
    state: a.state === "firing" ? "\\u25cf firing" : a.state,
    value: a.value == null ? "\\u2013" : (+a.value).toPrecision(3),
    threshold: `${a.cmp} ${a.threshold}`, severity: a.severity,
    since: a.for_s == null ? "" : `${a.for_s.toFixed(0)}s`,
  }));
  listTable(alertsEl, rows);
}
// flight-recorder feed: the newest events, newest first
async function renderEvents(el, ev){
  const rows = ((ev && ev.events) || []).slice(-15).reverse().map(e => ({
    seq: e.seq, kind: e.kind,
    subtask: e.subtask_id ? `${(e.job_id || "").slice(0, 8)}/${e.subtask_id}` : "",
    worker: e.worker_id || "", attempt: e.attempt == null ? "" : e.attempt,
    detail: JSON.stringify(e.data).slice(0, 120),
  }));
  listTable(el, rows);
}
async function tick(){
  // fire-and-forget scrape: refreshes the derived gauges (route p99) and
  // drives the time-series sampler even on direct-mode coordinators that
  // have no sweep loop and no external Prometheus
  fetch("/metrics/prom").catch(() => {});
  const [h, jobs, workers, queues, sup, ev, al, sc] = await Promise.all(
    ["/health", "/jobs", "/workers", "/queues", "/supervisor",
     "/events?limit=500", "/alerts", "/autoscale"].map(get));
  const he = document.getElementById("health");
  he.textContent = h ? h.status : "unreachable";
  he.className = h && h.status === "ok" ? "ok" : "bad";
  document.getElementById("jobs").tBodies[0].innerHTML =
    (Array.isArray(jobs) ? jobs : []).map(j => `<tr>
    <td>${esc(j.job_id)}</td><td>${esc(j.model_type)}</td><td>${esc(j.dataset_id)}</td>
    <td class="${j.status === "completed" ? "ok" : (j.status === "failed" || j.status === "completed_with_failures") ? "bad" : ""}">${esc(j.status)}</td>
    <td>${esc(j.completed_subtasks)}</td><td>${esc(j.failed_subtasks)}</td>
    <td>${esc(j.pruned_subtasks || 0)}</td>
    <td class="${j.diverged_subtasks ? "bad" : ""}">${esc(j.diverged_subtasks || 0)}</td>
    <td>${esc(j.total_subtasks)}</td><td>${esc((j.session_id || "").slice(0, 8))}</td></tr>`).join("")
    || "<tr><td colspan=10>no jobs yet</td></tr>";
  kvTable(document.getElementById("workers"), workers);
  kvTable(document.getElementById("queues"), queues);
  listTable(document.getElementById("sup"), sup);
  renderEvents(document.getElementById("events"), ev);
  renderHealth(document.getElementById("autoscale"),
               document.getElementById("alerts"), sc, al);
  await renderSparks(document.getElementById("spark"), SPARKS);
  await renderSparks(document.getElementById("perfspark"), PERF_SPARKS);
  const latest = Array.isArray(jobs) && jobs.length ? jobs[0].job_id : null;
  renderTrace(document.getElementById("trace"),
              latest ? await get(`/trace/${latest}`) : null);
  renderCritPath(document.getElementById("critpath"),
                 latest ? await get(`/critical_path/${latest}`) : null);
  renderCurves(document.getElementById("curves"),
               latest ? await get(`/curves/${latest}`) : null);
  renderCost(document.getElementById("cost"),
             latest ? await get(`/cost/${latest}`) : null);
  document.getElementById("ts").textContent = new Date().toLocaleTimeString();
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""

#: profiler error reasons -> HTTP status: the valve off is 503, an open or
#: absent capture a 409, a backend or filesystem failure a 500
_PROFILE_STATUS = {"disabled": 503, "busy": 409, "idle": 409, "backend": 500}

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
            ("GET", "/dashboard", "dashboard"),
            ("GET", "/metrics/prom", "metrics_prom"),
            ("POST", "/profile/start", "profile_start"),
            ("POST", "/profile/stop", "profile_stop"),
            ("GET", "/profile/status", "profile_status"),
            ("GET", "/trace/<jid>", "trace"),
            ("GET", "/trace/<jid>/export", "trace_export"),
            ("GET", "/critical_path/<jid>", "critical_path_report"),
            ("POST", "/trace_spans/<wid>", "trace_spans"),
            ("GET", "/cost/<jid>", "cost"),
            ("GET", "/healthz", "healthz"),
            ("GET", "/livez", "livez"),
            ("GET", "/readyz", "readyz"),
            ("GET", "/explain/<jid>/<stid>", "explain"),
            ("GET", "/explain/<jid>", "explain_job"),
            ("GET", "/curves/<jid>", "curves_job"),
            ("GET", "/curves/<jid>/<stid>", "curves_subtask"),
            ("GET", "/events", "events"),
            ("GET", "/alerts", "alerts"),
            ("GET", "/autoscale", "autoscale"),
            ("GET", "/metrics/history", "metrics_history"),
            ("GET", "/predictor/calibration", "predictor_calibration"),
            ("POST", "/subscribe", "subscribe"),
            ("POST", "/unsubscribe/<wid>", "unsubscribe"),
            ("POST", "/heartbeat/<wid>", "heartbeat"),
            ("GET", "/next_tasks/<wid>", "next_tasks"),
            ("POST", "/task_result/<wid>", "task_result"),
            ("POST", "/task_metrics/<wid>", "task_metrics"),
            ("GET", "/dataset/<dataset_id>", "dataset"),
            ("POST", "/slice_heartbeat/<slice_id>/<rank>", "slice_heartbeat"),
            ("GET", "/slice_status/<slice_id>", "slice_status"),
            ("POST", "/migrate_in", "migrate_in"),
            ("POST", "/migrate_job", "migrate_job"),
            ("GET", "/steal_candidates", "steal_candidates"),
            ("POST", "/steal_tasks", "steal_tasks"),
            ("POST", "/peer_result", "peer_result"),
        ):
            regex = "^" + re.sub(r"<(\w+)>", r"(?P<\1>[^/]+)", pattern) + "$"
            self._routes.append((method, re.compile(regex), endpoint))
        #: SPMD slice liveness: slice id -> {rank: last heartbeat}
        self._slices: Dict[str, Dict[int, float]] = {}
        self._slices_lock = threading.Lock()

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
        """Serve one request: (status, headers, body chunks). Errors become
        JSON ``{"status": "error", "message": ...}``: 404 for an unknown
        path, a KeyError or a missing file; the HTTPError's own code; 500
        for anything else. Every reply carries the CORS headers.

        The trace middleware: an ``X-Trace-Id`` header activates that trace
        for the handler, which runs inside an ``http.<endpoint>`` span
        (nested under ``X-Parent-Span`` when sent), and the id is echoed on
        the reply; untraced requests open no span, and the span transport
        (``/trace_spans``) is never traced. The RED middleware: every request
        lands in ``tpuml_http_request_seconds{route,method,code}`` (route =
        the endpoint's name; a streamed reply counts to its first byte)."""
        method = method.upper()
        if method == "OPTIONS":
            return 204, list(CORS_HEADERS), []
        hdr = {k.lower(): v for k, v in (headers or {}).items()}
        trace_id = hdr.get(TRACE_HEADER.lower())
        t0 = time.perf_counter()
        endpoint = None
        try:
            endpoint, values = self.match(method, path)
            counter_inc("tpuml_http_requests_total", endpoint=endpoint)
            handler = getattr(self, endpoint)
            if trace_id and endpoint != "trace_spans" and obs_enabled():
                with activate(trace_id, hdr.get(PARENT_HEADER.lower())):
                    with span(f"http.{endpoint}", trace_id=trace_id):
                        status, hdrs, chunks = handler(Request(query, body), **values)
            else:
                status, hdrs, chunks = handler(Request(query, body), **values)
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
        out = [*hdrs, *CORS_HEADERS]
        if trace_id:
            out.append((TRACE_HEADER, trace_id))
        return status, out, chunks

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
                "GET  /dashboard  (HTML)",
                "GET  /metrics/prom  (Prometheus exposition)",
                "POST /profile/start  (on-demand torch.profiler capture)",
                "POST /profile/stop",
                "GET  /profile/status",
                "GET  /metrics/history?name=&since=  (embedded time series)",
                "GET  /trace/<job_id>  (span tree)",
                "GET  /trace/<job_id>/export?format=perfetto|otlp",
                "GET  /critical_path/<job_id>[?compare=<job_id>]",
                "GET  /cost/<job_id>  (device cost report)",
                "GET  /explain/<job_id>/<subtask_id>  (decision timeline)",
                "GET  /curves/<job_id>[/<subtask_id>]  (learning curves)",
                "GET  /events?since=&limit=  (flight-recorder firehose)",
                "GET  /alerts  (SLO alert states)",
                "GET  /autoscale  (capacity signals)",
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
                "POST /slice_heartbeat/<slice_id>/<rank>  (SPMD slice watchdog)",
                "GET  /slice_status/<slice_id>",
                "POST /migrate_in  (shard rebalancing: adopt a job)",
                "POST /migrate_job  (move one of this shard's jobs to a peer)",
                "GET  /steal_candidates",
                "POST /steal_tasks",
                "POST /peer_result",
            ],
        })

    def _shard_keys(self, out: Dict[str, Any]) -> Dict[str, Any]:
        if self.coord.shard_id is not None:
            out["shard"] = self.coord.shard_id
            out["n_shards"] = self.coord.n_shards
        return out

    def _moved(self, jid) -> Optional[Reply]:
        """A migrated job's forwarding stamp: 409 with the destination
        shard, or None while this shard owns the job."""
        dest = self.coord.store.migrated_to(jid)
        if dest is None:
            return None
        return _json({"status": "moved", "migrated_to": dest, "job_id": jid}, 409)

    def health(self, request) -> Reply:
        out: Dict[str, Any] = self._shard_keys({"status": "ok"})
        slots = self._slots()
        if slots is not None:
            out["agent_slots"] = slots
            if slots["total"] and slots["gave_up"] == slots["total"]:
                out["status"] = "degraded"  # every executor slot is down
        return _json(out)

    def create_session(self, request) -> Reply:
        """Optional body ``{"session_id", "priority"}``: a sharded front end
        mints the session id (so ``shard_of`` and the owning shard agree);
        an unsharded coordinator always mints its own, and a shard refuses
        an id that hashes elsewhere (400)."""
        body = request.json(silent=True) or {}
        sid_req = body.get("session_id")
        coord = self.coord
        if sid_req is not None:
            if coord.shard_id is None:
                sid_req = None
            else:
                from .sharding import shard_of

                home = shard_of(sid_req, coord.n_shards)
                if home != coord.shard_id:
                    raise HTTPError(400, f"session id {sid_req!r} hashes to shard {home}, "
                                         f"not this shard ({coord.shard_id})")
        sid = coord.create_session(sid_req, priority=self._priority_or_400(body.get("priority")))
        out = {"session_id": sid}
        if coord.shard_id is not None:
            out["shard"] = coord.shard_id
        return _json(out, 201)

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
        canonical = self.coord.canonical_job_id(body["job_id"]) if body.get("job_id") else None
        known = bool(canonical and self.coord.store.has_job(sid, canonical))
        if known:
            # a resume of a job this shard handed off redirects; it never
            # resubmits a second live copy
            moved = self._moved(canonical)
            if moved is not None:
                return moved
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
        jid = self.coord.canonical_job_id(jid)
        return self._moved(jid) or _json(self.coord.check_status(sid, jid))

    def metrics(self, request, sid, jid) -> Reply:
        """Per-subtask results; ``?wait=1`` blocks until the job finalizes
        (the reference master's blocking /metrics)."""
        jid = self.coord.canonical_job_id(jid)
        moved = self._moved(jid)
        if moved is not None:
            return moved
        if request.args.get("wait"):
            timeout = float(request.args.get("timeout",
                                             self.coord.config.service.client_timeout_s))
            self.coord._require_session(sid)
            self.coord.store.wait_job(sid, jid, timeout)
        return _json(self.coord.job_metrics(sid, jid))

    def download_model(self, request, sid, jid) -> Reply:
        moved = self._moved(self.coord.canonical_job_id(jid))
        if moved is not None:
            return moved
        path = self.coord.best_model_path(sid, self.coord.canonical_job_id(jid))
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

    def dashboard(self, request) -> Reply:
        return 200, [("Content-Type", "text/html; charset=utf-8")], [_DASHBOARD_HTML.encode()]

    # ---------------- the observability plane ----------------

    def metrics_prom(self, request) -> Reply:
        """The Prometheus exposition, after the scrape-time refreshes: the
        fleet's size and per-worker health, the card's memory, the per-route
        p99 gauge, one time-series sample and the fleet-health tick (a
        direct-mode coordinator has no sweep to drive them)."""
        coord = self.coord
        if coord.cluster is not None:
            gauge_set("tpuml_workers_alive", len(coord.cluster.engine.workers))
            coord.cluster.engine.refresh_health_metrics()
        from .executor import record_hbm_gauges

        record_hbm_gauges()
        _record_kernel_launches()
        refresh_route_p99()
        timeseries_sample()
        coord.health_tick()
        return 200, [("Content-Type", "text/plain; version=0.0.4; charset=utf-8")], [
            render_prometheus().encode()]

    def profile_start(self, request) -> Reply:
        """Begin a ``torch.profiler`` capture (obs/devprof.py); the optional
        body ``{"tag": "..."}`` names its directory under
        ``<journal_dir>/profile/``. 201; 409 while a capture is open; 503
        with observability off; 500 when the profiler refuses (another
        session in the process) or the filesystem does."""
        body = request.json(silent=True) or {}
        out = PROFILER.start(body.get("tag"))
        if out["status"] == "started":
            return _json(out, 201)
        return _json(out, _PROFILE_STATUS.get(out.get("reason"), 500))

    def profile_stop(self, request) -> Reply:
        """Finish the capture and export its Chrome trace; 409 when none is
        open, 500 when the stop or export failed."""
        out = PROFILER.stop()
        if out["status"] == "stopped":
            return _json(out)
        return _json(out, _PROFILE_STATUS.get(out.get("reason"), 500))

    def profile_status(self, request) -> Reply:
        return _json(PROFILER.status())

    def cost(self, request, jid) -> Reply:
        """The job's device cost report (``Coordinator.job_cost``)."""
        report = self.coord.job_cost(jid)
        if report is None:
            return _json({"status": "error", "message": f"no job {jid!r}"}, 404)
        return _json(report)

    def trace(self, request, jid) -> Reply:
        tid = TRACER.trace_for_job(jid)
        if tid is None:
            return _json({"status": "error", "message": f"no trace for job {jid!r}"}, 404)
        spans = sorted(TRACER.spans_for(tid), key=lambda s: (s.get("start") or 0))
        return _json({"job_id": jid, "trace_id": tid, "n_spans": len(spans), "spans": spans,
                      "tree": TRACER.tree(tid)})

    def trace_export(self, request, jid) -> Reply:
        """The job's trace as ``?format=perfetto`` (default: Chrome trace
        JSON) or ``otlp``, written under the journal directory and returned
        inline; 400 on an unknown format, 404 when no trace is bound."""
        tid = TRACER.trace_for_job(jid)
        if tid is None:
            return _json({"status": "error", "message": f"no trace for job {jid!r}"}, 404)
        fmt = request.args.get("format", "perfetto")
        try:
            out = export_trace(tid, sorted(TRACER.spans_for(tid),
                                           key=lambda s: (s.get("start") or 0)),
                               fmt, job_id=jid)
        except ValueError as e:
            return _json({"status": "error", "message": str(e)}, 400)
        return _json(out)

    def critical_path_report(self, request, jid) -> Reply:
        """The job's critical path (``Coordinator.critical_path``);
        ``?compare=<job_id>`` adds a per-segment diff against that job as
        the baseline."""
        report = self.coord.critical_path(jid)
        if report is None:
            return _json({"status": "error",
                          "message": f"no critical path for job {jid!r} (no trace bound)"}, 404)
        baseline_id = request.args.get("compare")
        if baseline_id:
            baseline = self.coord.critical_path(baseline_id)
            if baseline is None:
                return _json({"status": "error", "message": "no critical path for baseline "
                              f"job {baseline_id!r}"}, 404)
            report = dict(report)
            report["diff"] = compare_critical_paths(baseline, report)
        return _json(report)

    def trace_spans(self, request, wid) -> Reply:
        """The agents' span shipping: the return leg of the trace
        propagation."""
        body = request.json(silent=True) or {}
        n = TRACER.ingest(body.get("spans") or [])
        counter_inc("tpuml_trace_spans_ingested_total", n)
        return _json({"status": "ok", "ingested": n})

    def explain(self, request, jid, stid) -> Reply:
        try:
            return _json(self.coord.explain(jid, stid))
        except KeyError as e:
            return _json({"status": "error", "message": str(e).strip("'")}, 404)

    def explain_job(self, request, jid) -> Reply:
        """The subtask ids with a recorded timeline for the job."""
        stids = RECORDER.job_subtasks(jid)
        if not stids:
            return _json({"status": "error",
                          "message": f"no recorded events for job {jid!r}"}, 404)
        return _json({"job_id": jid, "subtask_ids": stids})

    def events(self, request) -> Reply:
        """The flight recorder's firehose: events with seq > ``?since=``,
        oldest first, at most ``?limit=``; ``last_seq`` is the next cursor."""
        def _int_arg(name, default):
            try:
                return int(request.args.get(name, default))
            except ValueError:
                return default

        evts, last = RECORDER.events(since=_int_arg("since", 0), limit=_int_arg("limit", 1000))
        return _json({"events": evts, "n_events": len(evts), "last_seq": last})

    def alerts(self, request) -> Reply:
        """The alert rules' states, evaluated first (``?force=1`` skips the
        throttle)."""
        self.coord.health_tick(force=bool(request.args.get("force")))
        out = self.coord.alerts.snapshot()
        if self.coord.shard_id is not None:
            out["shard"] = self.coord.shard_id
        return _json(out)

    def autoscale(self, request) -> Reply:
        """The capacity signals (desired workers and shards, the raw
        signals, the hysteresis), evaluated first like /alerts."""
        self.coord.health_tick(force=bool(request.args.get("force")))
        out = dict(self.coord.signals.report())
        if self.coord.shard_id is not None:
            out["shard"] = self.coord.shard_id
        return _json(out)

    def metrics_history(self, request) -> Reply:
        """The embedded time series: ``?name=`` a metric family, ``?since=``
        epoch seconds; without a name, the sampled names."""
        name = request.args.get("name")
        if not name:
            return _json({"names": TIMESERIES.names()})
        try:
            since = float(request.args.get("since", 0.0))
        except ValueError:
            since = 0.0
        return _json({"name": name, "since": since,
                      "series": TIMESERIES.history(name, since=since)})

    def healthz(self, request) -> Reply:
        """Deep health: the coordinator's device and its memory, each
        worker's health (batch EWMA, heartbeat age, failure ratio, queue
        depth), the stragglers, readiness. Always 200; ``status`` says ok
        or degraded."""
        coord = self.coord
        out: Dict[str, Any] = self._shard_keys({"status": "ok", "obs_enabled": obs_enabled(),
                                                "ready": coord.ready})
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
        jid = self.coord.canonical_job_id(jid)
        moved = self._moved(jid)
        if moved is not None:
            return moved
        out = self.coord.job_curves(jid)
        if out is None:
            return _json({"status": "error", "message": f"no job {jid!r}"}, 404)
        return _json(out)

    def curves_subtask(self, request, jid, stid) -> Reply:
        jid = self.coord.canonical_job_id(jid)
        moved = self._moved(jid)
        if moved is not None:
            return moved
        try:
            return _json(self.coord.subtask_curves(jid, stid))
        except KeyError as e:
            return _json({"status": "error", "message": str(e).strip("'")}, 404)

    def predictor_calibration(self, request) -> Reply:
        return _json(self.coord.predictor_calibration())

    # ---------------- worker agents ----------------

    def subscribe(self, request) -> Reply:
        """Register a remote worker with its mesh-slice report (``n_devices``,
        ``mesh_shape``: the placement engine prices its batches per slice);
        the reply carries the prewarm hints (``prewarm``) when there are
        any."""
        body = request.json(silent=True) or {}
        n_devices = body.get("n_devices")
        if n_devices is not None:
            try:
                n_devices = int(n_devices)
            except (TypeError, ValueError):
                raise HTTPError(400, f"n_devices must be an integer, got {n_devices!r}")
        mesh_shape = body.get("mesh_shape")
        if mesh_shape is not None:
            try:
                mesh_shape = {str(k): int(v) for k, v in mesh_shape.items()}
            except (TypeError, ValueError, AttributeError):
                raise HTTPError(400, "mesh_shape must be an object of integer axis sizes, "
                                     f"got {mesh_shape!r}")
        wid = self._cluster_or_400().register_remote(body.get("mem_capacity_mb"),
                                                     n_devices=n_devices,
                                                     mesh_shape=mesh_shape)
        resp: Dict[str, Any] = {"worker_id": wid}
        try:
            hints = self.coord.prewarm_hints()
        except Exception:  # noqa: BLE001 — hints are advisory, never a failed registration
            logger.exception("Prewarm hints failed")
            hints = []
        if hints:
            resp["prewarm"] = hints
        return _json(resp, 201)

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


    # ---------------- SPMD slices and the shard rebalancing plane ----------------

    def slice_heartbeat(self, request, slice_id, rank) -> Reply:
        """A rank of an SPMD slice is alive (runtime/agent.py
        ``_slice_watchdog``); slices whose every rank is silent for 900 s
        are pruned."""
        try:
            rank = int(rank)
        except ValueError:
            raise HTTPError(400, f"rank must be an integer, got {rank!r}")
        now = time.time()
        with self._slices_lock:
            self._slices.setdefault(slice_id, {})[rank] = now
            for other in [k for k, ranks in self._slices.items()
                          if k != slice_id and ranks and now - max(ranks.values()) > 900]:
                del self._slices[other]
        return _json({"status": "ok"})

    def slice_status(self, request, slice_id) -> Reply:
        """Seconds since each rank's last heartbeat."""
        now = time.time()
        with self._slices_lock:
            ranks = dict(self._slices.get(slice_id, {}))
        return _json({"ranks": {str(r): round(now - ts, 3) for r, ts in ranks.items()}})

    def migrate_in(self, request) -> Reply:
        """A donor shard hands over a quiesced job's whole record; the
        recipient journals it before the donor stamps its move.
        Idempotent."""
        body = request.json(silent=True) or {}
        try:
            return _json(self.coord.migrate_in(body))
        except ValueError as e:
            return _json({"status": "error", "message": str(e)}, 400)

    def migrate_job(self, request) -> Reply:
        """An operator's move of one unfinished job to a peer shard: body
        ``{"session_id", "job_id", "dest_shard"}`` -> ``Coordinator.
        migrate_job`` (the rebalancer's own path; the JAX server has no
        such route). ``{"migrated": false}`` when the move was refused or
        aborted (the job then stays here)."""
        body = request.json()
        try:
            sid, jid, dest = body["session_id"], body["job_id"], int(body["dest_shard"])
        except (KeyError, TypeError, ValueError):
            raise HTTPError(400, "session_id, job_id and an integer dest_shard are required")
        jid = self.coord.canonical_job_id(jid)
        if not self.coord.store.has_job(sid, jid):
            return _json({"status": "error", "message": f"no job {jid!r}"}, 404)
        if dest == self.coord.shard_id:
            raise HTTPError(400, "dest_shard is this shard")
        return _json({"migrated": bool(self.coord.migrate_job(sid, jid, dest)),
                      "job_id": jid, "dest_shard": dest})

    def steal_candidates(self, request) -> Reply:
        return _json(self.coord.steal_candidates())

    def steal_tasks(self, request) -> Reply:
        """The steal grant: ``{"thief_shard", "max_n", "max_n_devices"?,
        "prefer_wide"?}`` -> fenced task attempts the thief may run; their
        results come back through ``/peer_result``."""
        body = request.json(silent=True) or {}
        try:
            thief = int(body.get("thief_shard", -1))
            max_n = int(body.get("max_n", self.coord.config.service.steal_max_tasks))
            max_nd = body.get("max_n_devices")
            max_nd = int(max_nd) if max_nd is not None else None
        except (TypeError, ValueError):
            raise HTTPError(400, "thief_shard, max_n and max_n_devices must be integers")
        return _json({"tasks": self.coord.release_for_steal(
            thief, max_n, max_n_devices=max_nd, prefer_wide=bool(body.get("prefer_wide")))})

    def peer_result(self, request) -> Reply:
        """Results relayed by a peer shard (``{"results": [...]}`` or one
        result), published on the local bus like a worker's."""
        body = request.json(silent=True) or {}
        results = body.get("results")
        if results is None:
            results = [body]
        n = 0
        for r in results:
            if isinstance(r, dict) and r.get("subtask_id"):
                self.coord.ingest_peer_result(r)
                n += 1
        return _json({"status": "ok", "ingested": n})


def _record_kernel_launches() -> None:
    """``tpuml_kernel_launches{kernel}``: each CUDA kernel wrapper's launch
    count in this process (``LAUNCHES`` of ops/cuda_*.py), read at scrape,
    so another process (a shard of a fleet) can read its launches."""
    from ..ops import cuda_hist, cuda_knn, cuda_logreg, cuda_mlp

    for mod in (cuda_logreg, cuda_hist, cuda_mlp, cuda_knn):
        for name, n in mod.LAUNCHES.items():
            gauge_set("tpuml_kernel_launches", float(n), kernel=name)


def _device_health(device) -> Dict[str, Any]:
    """The coordinator's device: reachability, kind, and on the card its
    memory (``utils/flops.py::device_memory_stats``)."""
    import torch

    from ..utils.flops import device_memory_stats

    if device.type != "cuda":
        return {"reachable": True, "platform": "cpu", "n_devices": 1, "device_kind": "cpu"}
    out = {
        "reachable": True,
        "platform": "gpu",
        "n_devices": torch.cuda.device_count(),
        "device_kind": torch.cuda.get_device_name(device),
    }
    stats = device_memory_stats()
    mem = {k: stats[k] for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
           if k in stats}
    if mem:
        out["memory"] = mem
    return out


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
    # the sharded control plane: this process serves one shard of N behind
    # stateless front ends (runtime/frontend.py)
    parser.add_argument("--shard-index", type=int, default=None, metavar="K",
                        help="serve shard K of a sharded control plane")
    parser.add_argument("--num-shards", type=int, default=1, metavar="N",
                        help="total shards in the fleet (with --shard-index)")
    parser.add_argument("--peers", default=None, metavar="URL,URL,...",
                        help="comma-separated shard base URLs (index = shard id) for "
                             "cross-shard migration and work stealing")
    args = parser.parse_args(argv)
    if args.direct and args.agent_executors > 0:
        parser.error("--agent-executors requires cluster mode (drop --direct)")
    if args.shard_index is not None and not 0 <= args.shard_index < max(args.num_shards, 1):
        parser.error("--shard-index must be in [0, --num-shards)")
    if args.num_shards > 100:
        parser.error("--num-shards is capped at 100 by the id stamp grammar")
    if args.shard_index is not None and args.direct:
        parser.error("--shard-index requires cluster mode (drop --direct)")

    from ..utils.config import get_config

    supervisor = None
    if args.direct:
        coord = Coordinator(device=args.device, journal=args.journal)
    else:
        from .cluster import ClusterRuntime

        shard_kwargs: Dict[str, Any] = {}
        if args.shard_index is not None:
            from .sharding import shard_service_config

            cfg = shard_service_config(get_config(), args.num_shards)
            shard_kwargs = {
                "config": cfg, "shard_id": args.shard_index, "n_shards": args.num_shards,
                "journal_dir": os.path.join(cfg.storage.journal_dir,
                                            f"shard-{args.shard_index}"),
            }
        cluster = ClusterRuntime(shard_id=args.shard_index)
        for _ in range(max(args.local_executors, 0)):
            cluster.add_executor(device=args.device)
        coord = Coordinator(device=args.device, cluster=cluster, journal=args.journal,
                            **shard_kwargs)
        if args.peers:
            coord.peer_urls = [u.strip().rstrip("/") for u in args.peers.split(",")
                               if u.strip()]
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
