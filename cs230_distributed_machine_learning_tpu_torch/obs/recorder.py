"""Flight recorder: the *decision* axis of observability.

The recording half of the JAX package's ``obs/recorder.py``
(framework-free): every lifecycle event (a result, a curve ingest, a rung
promotion, a prune, a cancel) gets a monotonically increasing ``seq`` and
is journaled to ``<journal_dir>/events.jsonl`` through the size-rotating
best-effort appender of ``.tracing``, one line an event in the JAX
package's schema, a job's lines written by the time the job reads as
finished:

    {"ts": 1754..., "kind": "promote", "job_id": "...", "subtask_id": "...",
     "worker_id": null, "attempt": 0, "data": {...kind-specific...},
     "seq": 42}

Everything is valve-gated by ``CS230_OBS`` (one env read per call when
disabled). The in-process firehose ring and per-subtask timelines that
serve ``GET /events`` and ``GET /explain`` come with them (ROADMAP A4).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .metrics import REGISTRY
from .tracing import _enabled, journal_append


class FlightRecorder:
    """Numbers lifecycle events and journals them (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seq = 0

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
        """Journal one lifecycle event. Returns the event (None when the
        valve is off)."""
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
        journal_append("events.jsonl", event)
        REGISTRY.counter("tpuml_recorder_events_total").inc(kind=kind)
        return event


#: the process-global recorder every runtime layer records into
RECORDER = FlightRecorder()


def record_event(kind: str, **kwargs: Any) -> None:
    """Module-level convenience over ``RECORDER.record`` (call sites read
    like the metric helpers: one import, one line, no-op when disabled)."""
    RECORDER.record(kind, **kwargs)
