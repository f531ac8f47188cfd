"""Dapper-style job tracing: spans with IDs propagated over the REST plane.

Port of the JAX package's ``obs/tracing.py`` (framework-free). One job's
timeline stitches across the whole chain, client (``client/manager.py``)
-> coordinator REST server (``runtime/server.py``) -> scheduler placement
-> executor batch -> remote agent (``runtime/agent.py``), through a single
``trace_id``:

- the client mints the id and sends it as an ``X-Trace-Id`` header;
- the server middleware activates it for the request (contextvar), so
  every span opened inside the handler inherits it;
- the coordinator stamps it into each subtask spec, so it rides the task
  bus / ``GET /next_tasks`` long-poll to worker agents;
- agents record executor spans into their own process-local tracer and
  ship them back with ``POST /trace_spans/<wid>`` (``X-Trace-Id`` on the
  request), where the coordinator's tracer ingests them.

``GET /trace/<job_id>`` then returns the ordered span tree. Spans live in
a bounded per-trace ring (oldest whole traces evicted) and, best-effort,
in a JSONL journal under the storage root, whose writer (shared with the
flight recorder's event journal) buffers its lines until
``flush_journal``.

Everything here is valve-gated by ``CS230_OBS`` (see obs/__init__.py):
disabled, ``span()`` yields a shared no-op and records nothing.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

#: active (trace_id, span_id) for the current thread/context — the
#: propagation vehicle between nested spans and across the server
#: middleware -> handler boundary. New threads start empty: cross-thread
#: hops (coordinator job threads, executor workers) pass trace ids
#: explicitly (thread args / task specs).
_CTX: contextvars.ContextVar = contextvars.ContextVar("tpuml_trace", default=None)

#: tracer override for the current context — lets a worker agent route its
#: executor spans into a private tracer (drained and shipped over REST)
#: while the rest of the process keeps the global one
_SINK: contextvars.ContextVar = contextvars.ContextVar("tpuml_tracer", default=None)

#: max whole traces kept; oldest trace evicted wholesale (a job's spans
#: stay together — partial timelines are worse than absent ones)
_MAX_TRACES = 256
#: max spans within one trace (runaway instrumentation guard)
_MAX_SPANS_PER_TRACE = 2048
#: job-id -> trace-id bindings kept
_MAX_JOBS = 1024

TRACE_HEADER = "X-Trace-Id"
#: parent-span propagation for multi-hop stitching: a front end sends the
#: span id of its open ``frontend.proxy`` span so the shard's
#: ``http.<endpoint>`` span nests under it instead of surfacing as a
#: second root (docs/OBSERVABILITY.md "Critical path & trace export")
PARENT_HEADER = "X-Parent-Span"


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


def _enabled() -> bool:
    return os.environ.get("CS230_OBS", "1") != "0"


def _journal_enabled() -> bool:
    return os.environ.get("CS230_OBS_JOURNAL", "1") != "0"


def _journal_max_bytes() -> int:
    """Size cap per journal file (spans.jsonl / events.jsonl) before a
    rotation. Long-lived coordinators used to grow spans.jsonl without
    bound across sessions; now the file rolls to ``<name>.1`` (one rotated
    generation kept) when it crosses the cap."""
    try:
        return int(float(os.environ.get("CS230_JOURNAL_MAX_MB", "64")) * 1e6)
    except ValueError:
        return int(64e6)


def journal_dir() -> str:
    """Resolve the journal directory: ``CS230_JOURNAL_DIR`` pins it to one
    place regardless of the configured storage root — CI uses it to
    collect every span/event of a test run (whose fixtures re-root storage
    per test) into a single uploadable artifact (deploy/ci.sh)."""
    d = os.environ.get("CS230_JOURNAL_DIR")
    if not d:
        from ..utils.config import get_config

        d = get_config().storage.journal_dir
    return d


#: journal path -> its lines not yet written, in order. A search journals
#: a few events a trial, and on a slow filesystem an open and a close a
#: line cost more than the line (tools/job_ab.py measures both)
_PENDING: Dict[str, List[str]] = {}
_LOCK = threading.Lock()
#: lines a file holds before they are written without waiting for a flush
_MAX_PENDING = 1024


def _write(path: str, lines: List[str]) -> None:
    """Append ``lines`` to ``path`` (its directory made when missing) and
    roll the file to ``<name>.1`` once the append leaves it past the cap.
    Any filesystem failure drops the lines."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write("".join(lines))
            size = f.tell()
        if size > _journal_max_bytes():
            os.replace(path, path + ".1")
    except Exception:  # noqa: BLE001 — observability must never fail a job
        pass


def journal_append(basename: str, obj: Dict[str, Any]) -> None:
    """Best-effort size-rotated JSONL append under the journal dir: the
    same lines as the JAX package's writer, buffered until
    ``flush_journal`` (the coordinator flushes before a job is finalized,
    and the process at exit) or until a file holds ``_MAX_PENDING``.
    ``CS230_OBS_JOURNAL=0`` drops every line (the in-process rings stay
    authoritative)."""
    if not _journal_enabled():
        return
    try:
        path = os.path.join(journal_dir(), basename)
        line = json.dumps(obj, default=str) + "\n"
    except Exception:  # noqa: BLE001
        return
    with _LOCK:
        pending = _PENDING.setdefault(path, [])
        pending.append(line)
        if len(pending) >= _MAX_PENDING:
            _write(path, pending)
            del _PENDING[path]


def flush_journal() -> None:
    """Write every buffered journal line, each file's in order."""
    with _LOCK:
        for path, lines in _PENDING.items():
            _write(path, lines)
        _PENDING.clear()


atexit.register(flush_journal)


class SpanHandle:
    """Mutable view of an open span: add attributes mid-flight
    (``sp.attrs["n_subtasks"] = 12``) or read ids for manual child spans."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start", "attrs")

    def __init__(self, trace_id, span_id, parent_id, name, start, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.attrs = attrs


class Tracer:
    """Bounded in-process span store, indexed by trace id.

    ``pending=True`` additionally queues every recorded span into a drain
    buffer — the worker-agent mode, where spans are shipped to the
    coordinator over REST after each batch (``drain()``).
    """

    def __init__(self, *, pending: bool = False, journal: bool = True):
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, List[Dict[str, Any]]]" = (
            collections.OrderedDict()
        )
        self._jobs: "collections.OrderedDict[str, str]" = collections.OrderedDict()
        self._pending: Optional[collections.deque] = (
            collections.deque(maxlen=4096) if pending else None
        )
        self._journal = journal

    # ---------------- recording ----------------

    def record(self, span: Dict[str, Any]) -> None:
        """Store one finished span dict (keys: trace_id, span_id, parent_id,
        name, start, end, attrs, process)."""
        tid = span.get("trace_id")
        if not tid:
            return
        dropped: Dict[str, int] = {}
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                spans = []
                self._traces[tid] = spans
                while len(self._traces) > _MAX_TRACES:
                    # whole-trace eviction, oldest first (insertion /
                    # last-touch order); every span of the victim is a drop
                    _vid, victim = self._traces.popitem(last=False)
                    dropped["trace_evicted"] = (
                        dropped.get("trace_evicted", 0) + len(victim)
                    )
            else:
                self._traces.move_to_end(tid)
            if len(spans) < _MAX_SPANS_PER_TRACE:
                spans.append(span)
            else:
                # runaway-instrumentation guard hit: the span never lands
                # in the ring (the journal line below still writes)
                dropped["trace_full"] = dropped.get("trace_full", 0) + 1
            if self._pending is not None:
                self._pending.append(span)
        if dropped:
            self._count_dropped(dropped)
        if self._journal:
            self._journal_write(span)

    @staticmethod
    def _count_dropped(dropped: Dict[str, int]) -> None:
        """Surface ring overflow (``tpuml_trace_spans_dropped_total``,
        labeled by reason) — a silent drop reads as 'the job recorded
        nothing there', which is exactly the lie the critical-path
        engine's ``untraced`` contract exists to avoid. Lazy import:
        metrics imports nothing from here, but the facade imports both,
        so the top level must stay acyclic."""
        try:
            from .metrics import REGISTRY

            for reason, n in dropped.items():
                REGISTRY.counter("tpuml_trace_spans_dropped_total").inc(
                    n, reason=reason
                )
        except Exception:  # noqa: BLE001 — accounting must not fail recording
            pass

    def ingest(self, spans: List[Dict[str, Any]]) -> int:
        """Accept remotely-recorded spans (the /trace_spans route). Returns
        how many were stored; malformed entries are dropped, not fatal."""
        n = 0
        for s in spans or []:
            if isinstance(s, dict) and s.get("trace_id") and s.get("name"):
                self.record(dict(s))
                n += 1
        return n

    def drain(self) -> List[Dict[str, Any]]:
        """Pop all pending-export spans (agent mode)."""
        if self._pending is None:
            return []
        out: List[Dict[str, Any]] = []
        with self._lock:
            while self._pending:
                out.append(self._pending.popleft())
        return out

    # ---------------- job binding / reads ----------------

    def bind_job(self, job_id: str, trace_id: str) -> None:
        with self._lock:
            self._jobs[job_id] = trace_id
            while len(self._jobs) > _MAX_JOBS:
                self._jobs.popitem(last=False)

    def trace_for_job(self, job_id: str) -> Optional[str]:
        with self._lock:
            return self._jobs.get(job_id)

    def spans_for(self, trace_id: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._traces.get(trace_id, [])]

    def traces(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def tree(self, trace_id: str) -> List[Dict[str, Any]]:
        """Span forest for a trace: children nested under parents, siblings
        ordered by start time. Spans whose parent never arrived (e.g. a
        remote hop that predates ingestion) surface as roots — a partial
        timeline beats a dropped one."""
        spans = self.spans_for(trace_id)
        by_id = {s["span_id"]: {**s, "children": []} for s in spans}
        roots: List[Dict[str, Any]] = []
        for node in by_id.values():
            parent = by_id.get(node.get("parent_id"))
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)

        def _sort(nodes):
            nodes.sort(key=lambda n: (n.get("start") or 0, n["span_id"]))
            for n in nodes:
                _sort(n["children"])

        _sort(roots)
        return roots

    # ---------------- journal ----------------

    def _journal_write(self, span: Dict[str, Any]) -> None:
        """Size-rotated JSONL append under the storage journal dir (see
        :func:`journal_append`)."""
        journal_append("spans.jsonl", span)


#: the process-global tracer (coordinator side)
TRACER = Tracer()


def active_tracer() -> Tracer:
    return _SINK.get() or TRACER


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Route spans opened in this context into ``tracer`` (agent mode)."""
    token = _SINK.set(tracer)
    try:
        yield tracer
    finally:
        _SINK.reset(token)


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def current_span_id() -> Optional[str]:
    """Span id of the innermost open span in this context (None outside any
    span) — the JSON log formatter stamps it into records so logs join
    metrics and traces on one id."""
    ctx = _CTX.get()
    return ctx[1] if ctx else None


@contextlib.contextmanager
def activate(trace_id: str, span_id: Optional[str] = None):
    """Make ``trace_id`` the ambient trace for this context — the server
    middleware (header -> context) and cross-thread handoffs use this."""
    token = _CTX.set((trace_id, span_id))
    try:
        yield
    finally:
        _CTX.reset(token)


class _NoopSpan:
    """Shared do-nothing handle for the disabled path: attribute writes
    land in throwaway slots."""

    __slots__ = ("attrs", "start")

    def __init__(self):
        self.attrs: Dict[str, Any] = {}
        self.start = 0.0

    trace_id = None
    span_id = None


_NOOP = _NoopSpan()


@contextlib.contextmanager
def span(
    name: str,
    *,
    trace_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    tracer: Optional[Tracer] = None,
    process: Optional[str] = None,
    **attrs: Any,
):
    """Record a timed span. Trace/parent ids resolve from the ambient
    context unless given explicitly; with no ambient trace and no explicit
    id a fresh trace starts. Yields a :class:`SpanHandle` whose ``attrs``
    can be extended mid-span; the span records on exit (errors are noted
    in ``attrs['error']`` and re-raised)."""
    if not _enabled():
        _NOOP.attrs.clear()
        yield _NOOP
        return
    ctx = _CTX.get()
    tid = trace_id or (ctx[0] if ctx else None) or new_trace_id()
    pid = parent_id if parent_id is not None else (
        ctx[1] if ctx and ctx[0] == tid else None
    )
    sid = new_span_id()
    handle = SpanHandle(tid, sid, pid, name, time.time(), dict(attrs))
    token = _CTX.set((tid, sid))
    try:
        yield handle
    except BaseException as e:
        handle.attrs["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _CTX.reset(token)
        t = tracer or active_tracer()
        t.record(
            {
                "trace_id": tid,
                "span_id": sid,
                "parent_id": pid,
                "name": name,
                "start": handle.start,
                "end": time.time(),
                "attrs": handle.attrs,
                "process": process or _process_tag(),
            }
        )


def record_phase(
    parent: Any,
    name: str,
    duration_s: float,
    *,
    start: Optional[float] = None,
    tracer: Optional[Tracer] = None,
    **attrs: Any,
) -> Optional[float]:
    """Record a synthesized child span from a measured duration — the
    vehicle for surfacing the trial engine's phase timers (compile /
    stage / dispatch / fetch) as timeline entries. ``parent`` is the
    enclosing SpanHandle; phases lay out sequentially from ``start``
    (default: parent start). Returns the phase's end time so callers can
    chain phases; no-op (returns None) when disabled or parent is a
    no-op span."""
    if not _enabled() or getattr(parent, "span_id", None) is None:
        return None
    t0 = parent.start if start is None else start
    t = tracer or active_tracer()
    t.record(
        {
            "trace_id": parent.trace_id,
            "span_id": new_span_id(),
            "parent_id": parent.span_id,
            "name": name,
            "start": t0,
            "end": t0 + max(float(duration_s), 0.0),
            "attrs": {"synthesized": True, **attrs},
            "process": _process_tag(),
        }
    )
    return t0 + max(float(duration_s), 0.0)


def _process_tag() -> str:
    return f"pid:{os.getpid()}"


_PROC_TOKEN: Optional[str] = None


def process_token() -> str:
    """Host-qualified identity of THIS process (``host:pid``) — the
    observation-source stamp on metrics/result messages. Bare pids are
    only unique per host, so a cross-host collision with the
    coordinator's pid would silently drop a remote agent's ingest."""
    global _PROC_TOKEN
    if _PROC_TOKEN is None:
        import socket

        _PROC_TOKEN = f"{socket.gethostname()}:{os.getpid()}"
    return _PROC_TOKEN
