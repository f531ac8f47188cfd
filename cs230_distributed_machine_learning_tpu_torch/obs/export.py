"""Trace export: Perfetto Chrome-JSON and OTLP-shaped JSON documents.

A copy of the JAX package's ``obs/export.py`` (framework-free).

The tracer's native formats (the in-process ring behind
``GET /trace/<job_id>`` and the ``spans.jsonl`` journal) are bespoke —
no external tool opens them. This module converts a trace's span list
into the two interchange formats that matter:

- **Perfetto / Chrome trace JSON** (``format=perfetto``): the
  ``traceEvents`` array of complete ("ph": "X") events that
  https://ui.perfetto.dev and chrome://tracing load directly. One
  Perfetto *process* per recording process tag (coordinator pid, each
  agent pid, the front end), spans laid out on depth-based tracks.
- **OTLP-shaped JSON** (``format=otlp``): the ``resourceSpans`` →
  ``scopeSpans`` → ``spans`` shape of the OpenTelemetry protobuf JSON
  encoding, with ids padded to OTLP widths (32-hex trace / 16-hex span)
  and times in unix nanoseconds — paste-ready for any OTLP ingest.

``export_trace`` writes the document under the journal dir
(``trace_<trace_id>.<format>.json``) and returns it, which is what
``GET /trace/<job_id>/export?format=`` serves
(docs/OBSERVABILITY.md "Critical path & trace export").
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .tracing import journal_dir

FORMATS = ("perfetto", "otlp")


def _f(v: Any, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _safe_attrs(attrs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = {}
    for k, v in (attrs or {}).items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = str(v)
    return out


def _depth(span: Dict[str, Any], by_id: Dict[str, Dict[str, Any]]) -> int:
    """Ancestor count, cycle-guarded (a malformed parent chain must not
    hang the exporter)."""
    d, seen = 0, set()
    cur = span
    while True:
        pid = cur.get("parent_id")
        if not pid or pid in seen or pid not in by_id:
            return d
        seen.add(pid)
        cur = by_id[pid]
        d += 1


def to_perfetto(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace JSON ("JSON Array Format" with the object wrapper):
    ``{"traceEvents": [...], "displayTimeUnit": "ms"}``. Timestamps are
    microseconds relative to the earliest span start (Chrome renders
    relative time; absolute epoch-µs values also load but read poorly)."""
    by_id = {s.get("span_id"): s for s in spans if s.get("span_id")}
    t0 = min((_f(s.get("start")) for s in spans), default=0.0)
    procs: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in sorted(spans, key=lambda s: _f(s.get("start"))):
        proc = str(s.get("process") or "unknown")
        if proc not in procs:
            pid = len(procs) + 1
            procs[proc] = pid
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": proc},
            })
        start = _f(s.get("start"))
        dur = max(_f(s.get("end")) - start, 0.0)
        events.append({
            "ph": "X",
            "name": str(s.get("name") or "span"),
            "cat": "tpuml",
            "pid": procs[proc],
            "tid": _depth(s, by_id),
            "ts": round((start - t0) * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "args": {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                **_safe_attrs(s.get("attrs")),
            },
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "tpuml", "t0_epoch_s": t0},
    }


def _otlp_id(hexid: Optional[str], width: int) -> str:
    h = str(hexid or "")
    return h.ljust(width, "0")[:width]


def _otlp_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def to_otlp(spans: List[Dict[str, Any]],
            service_name: str = "tpuml") -> Dict[str, Any]:
    """OTLP/JSON-shaped document: one ``resourceSpans`` entry per
    recording process, ids padded to the OTLP hex widths."""
    by_proc: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_proc.setdefault(str(s.get("process") or "unknown"), []).append(s)
    resource_spans = []
    for proc in sorted(by_proc):
        otlp_spans = []
        for s in sorted(by_proc[proc], key=lambda s: _f(s.get("start"))):
            start_ns = int(_f(s.get("start")) * 1e9)
            end_ns = max(int(_f(s.get("end")) * 1e9), start_ns)
            entry = {
                "traceId": _otlp_id(s.get("trace_id"), 32),
                "spanId": _otlp_id(s.get("span_id"), 16),
                "name": str(s.get("name") or "span"),
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(end_ns),
                "attributes": [
                    {"key": k, "value": _otlp_value(v)}
                    for k, v in _safe_attrs(s.get("attrs")).items()
                    if v is not None
                ],
            }
            if s.get("parent_id"):
                entry["parentSpanId"] = _otlp_id(s.get("parent_id"), 16)
            otlp_spans.append(entry)
        resource_spans.append({
            "resource": {
                "attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": service_name}},
                    {"key": "tpuml.process",
                     "value": {"stringValue": proc}},
                ]
            },
            "scopeSpans": [{
                "scope": {"name": "tpuml.tracing"},
                "spans": otlp_spans,
            }],
        })
    return {"resourceSpans": resource_spans}


def export_trace(
    trace_id: str,
    spans: List[Dict[str, Any]],
    fmt: str = "perfetto",
    *,
    job_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Render ``spans`` in ``fmt`` and write the document under the
    journal dir as ``trace_<trace_id>.<fmt>.json``. Returns
    ``{format, path, trace_id, job_id, n_spans, document}``; raises
    ValueError on an unknown format (the route's 400). A filesystem
    failure leaves ``path`` None — the document is still returned, so
    the caller can relay it even on a read-only journal dir."""
    if fmt not in FORMATS:
        raise ValueError(
            f"unknown export format {fmt!r} (one of {', '.join(FORMATS)})"
        )
    doc = to_perfetto(spans) if fmt == "perfetto" else to_otlp(spans)
    path: Optional[str] = None
    try:
        d = journal_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace_{trace_id}.{fmt}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
    except OSError:
        path = None
    return {
        "format": fmt,
        "path": path,
        "trace_id": trace_id,
        "job_id": job_id,
        "n_spans": len(spans),
        "document": doc,
    }
