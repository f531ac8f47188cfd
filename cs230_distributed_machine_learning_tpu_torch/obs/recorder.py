"""Flight recorder: the *decision* axis of observability.

A copy of the JAX package's ``obs/recorder.py`` (framework-free); its
event journal goes through the port's buffered writer (``.tracing``).

Spans (``.tracing``) answer "where did job X spend its time"; the metrics
registry (``.metrics``) answers "how much of Y happened". Neither can
reconstruct a scheduling DECISION after the fact — why subtask S landed on
worker W, what the predictor estimated, which workers were excluded or
penalized, why a lease was reclaimed, which attempt a retry superseded.
Since the fault-tolerance layer (docs/ROBUSTNESS.md) made the runtime
predictor load-bearing for correctness (lease deadlines, reclaim
decisions, speculation triggers, breaker evictions all derive from its
estimates), those decisions must be explainable.

The recorder is a bounded, thread-safe event log with two indices:

- a **firehose ring**: every event in arrival order, addressed by a
  monotonically increasing ``seq`` — served at ``GET /events?since=``.
- **per-subtask timelines**: events carrying ``job_id`` + ``subtask_id``
  are additionally indexed by that pair — served at
  ``GET /explain/<job_id>/<subtask_id>`` as the subtask's lifecycle
  (placement with full score breakdown -> lease grant -> reclaim/retry/
  speculation -> terminal result or quarantine).

Event schema (documented in docs/OBSERVABILITY.md "Flight recorder"):

    {"seq": 42, "ts": 1754..., "kind": "placement",
     "job_id": "...", "subtask_id": "...", "worker_id": "worker-1",
     "attempt": 0, "data": {...kind-specific...}}

Everything is valve-gated by ``CS230_OBS`` (one env read per call when
disabled — the same contract as the metric helpers). Events are also
journaled to
``<journal_dir>/events.jsonl`` next to the span journal, through the same
size-rotating best-effort appender.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import REGISTRY
from .tracing import _enabled, journal_append

#: firehose depth — events kept for GET /events (oldest evicted)
_MAX_EVENTS = 8192
#: distinct (job_id, subtask_id) timelines kept (oldest evicted wholesale)
_MAX_SUBTASKS = 4096
#: events within one subtask's timeline (runaway-retry guard)
_MAX_EVENTS_PER_SUBTASK = 256


class FlightRecorder:
    """Bounded in-process lifecycle event store (see module docstring)."""

    def __init__(
        self,
        *,
        max_events: int = _MAX_EVENTS,
        max_subtasks: int = _MAX_SUBTASKS,
        journal: bool = True,
    ):
        self._lock = threading.Lock()
        self._seq = 0
        self._ring: collections.deque = collections.deque(maxlen=max_events)
        self._timelines: "collections.OrderedDict[Tuple[str, str], List[Dict[str, Any]]]" = (
            collections.OrderedDict()
        )
        self._max_subtasks = max_subtasks
        self._journal = journal

    # ---------------- recording ----------------

    def record(
        self,
        kind: str,
        *,
        job_id: Optional[str] = None,
        subtask_id: Optional[str] = None,
        worker_id: Optional[str] = None,
        attempt: Optional[int] = None,
        **data: Any,
    ) -> Optional[Dict[str, Any]]:
        """Append one lifecycle event. Returns the stored event (None when
        the valve is off). Events without a (job_id, subtask_id) pair —
        e.g. worker-scoped breaker transitions — land in the firehose
        only."""
        if not _enabled():
            return None
        event: Dict[str, Any] = {
            "ts": time.time(),
            "kind": kind,
            "job_id": job_id,
            "subtask_id": subtask_id,
            "worker_id": worker_id,
            "attempt": attempt,
            "data": data,
        }
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)
            if job_id and subtask_id:
                key = (job_id, subtask_id)
                timeline = self._timelines.get(key)
                if timeline is None:
                    timeline = []
                    self._timelines[key] = timeline
                    while len(self._timelines) > self._max_subtasks:
                        self._timelines.popitem(last=False)
                else:
                    self._timelines.move_to_end(key)
                if len(timeline) < _MAX_EVENTS_PER_SUBTASK:
                    timeline.append(event)
        if self._journal:
            journal_append("events.jsonl", event)
        REGISTRY.counter("tpuml_recorder_events_total").inc(kind=kind)
        return event

    # ---------------- queries ----------------

    def timeline(
        self, job_id: str, subtask_id: str
    ) -> Optional[List[Dict[str, Any]]]:
        """All events for one subtask in seq order, or None when the pair
        was never recorded (the /explain 404 signal — distinct from an
        empty-but-known timeline, which cannot occur: a timeline exists
        only once its first event lands)."""
        with self._lock:
            timeline = self._timelines.get((job_id, subtask_id))
            return [dict(e) for e in timeline] if timeline is not None else None

    def job_subtasks(self, job_id: str) -> List[str]:
        """Subtask ids with a recorded timeline for ``job_id`` (the
        /explain discovery aid)."""
        with self._lock:
            return sorted(
                stid for jid, stid in self._timelines if jid == job_id
            )

    def events(
        self, since: int = 0, limit: int = 1000
    ) -> Tuple[List[Dict[str, Any]], int]:
        """Firehose read: events with ``seq > since`` (oldest first, at
        most ``limit``) plus the cursor for the next poll — the recorder's
        latest seq, EXCEPT when ``limit`` truncated the batch, where it is
        the last RETURNED event's seq (a poller resuming from the global
        latest would silently skip the truncated remainder). A ``since``
        older than the ring's tail silently skips the evicted gap (bounded
        memory beats complete history)."""
        with self._lock:
            out = [dict(e) for e in self._ring if e["seq"] > since]
            latest = self._seq
        limit = max(int(limit), 0)
        if len(out) > limit:
            out = out[:limit]
            return out, (out[-1]["seq"] if out else since)
        return out, latest

    def last_seq(self) -> int:
        with self._lock:
            return self._seq


#: the process-global recorder every runtime layer records into
RECORDER = FlightRecorder()


def record_event(kind: str, **kwargs: Any) -> None:
    """Module-level convenience over ``RECORDER.record`` (call sites read
    like the metric helpers: one import, one line, no-op when disabled)."""
    RECORDER.record(kind, **kwargs)
