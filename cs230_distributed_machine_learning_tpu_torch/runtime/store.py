"""In-memory, journaled job/session state store.

Port of the direct-mode subset of the JAX package's ``runtime/store.py``:
plain dicts guarded by one lock, plus an append-only JSONL journal in the
same format (``jobs.jsonl``, ops ``create_session`` / ``create_job`` /
``update_subtask`` / ``curve`` / ``finalize_job``), so a restarted
coordinator can read back the jobs it ran and their learning curves.

Status semantics: ``status`` is "pending" until the first subtask ends,
then a percentage string, then "completed"; failed, pruned and diverged
subtasks count toward completion. ``promoted`` (an adaptive-search rung
boundary) stores its result without counting.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..utils.serialization import json_safe

#: job statuses past which no further transitions happen
TERMINAL_STATUSES = ("completed", "failed")

#: per-subtask terminal statuses. ``pruned`` is the adaptive-search
#: contract (docs/SEARCH.md): a non-failure terminal for a trial the rung
#: controller stopped early. ``diverged`` is the numerical-health
#: watchdog's verdict: the trial's learning curve went non-finite or blew
#: past the divergence threshold; terminal like ``pruned``, never a
#: failure.
SUBTASK_TERMINAL_STATUSES = ("completed", "failed", "pruned", "diverged")


def _done(job: Dict[str, Any]) -> int:
    """Subtasks of ``job`` in a terminal status."""
    return (job["completed_subtasks"] + job["failed_subtasks"]
            + job.get("pruned_subtasks", 0) + job.get("diverged_subtasks", 0))


def _final_status(result) -> str:
    return "failed" if (result or {}).get("status") == "failed" else "completed"


class JobStore:
    def __init__(self, journal_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._done_events: Dict[tuple, threading.Event] = {}
        self._journal_path = None
        #: replay forensics: entries applied by op, entries skipped (torn
        #: or referring to state the journal never created)
        self.replay_ops: Dict[str, int] = {}
        self.replay_skipped = 0
        #: ``curve`` entries seen during replay, drained once by the
        #: coordinator into its CurveStore
        self._replayed_curves: List[Dict[str, Any]] = []
        if journal_dir:
            os.makedirs(journal_dir, exist_ok=True)
            self._journal_path = os.path.join(journal_dir, "jobs.jsonl")
            self._replay()

    # ---------------- sessions ----------------

    def create_session(self, session_id: Optional[str] = None, priority: int = 0) -> str:
        """Create (or idempotently re-create) a session. ``priority`` is the
        session's QoS lane, kept in its record and journaled, as in the JAX
        package (the port's direct mode runs one job queue, so no lane
        dispatches ahead of another yet)."""
        sid = session_id or str(uuid.uuid4())
        with self._lock:
            self._sessions.setdefault(
                sid, {"created_at": time.time(), "jobs": {}, "priority": int(priority)})
        self._journal({"op": "create_session", "sid": sid, "priority": int(priority)})
        return sid

    def session_priority(self, sid: str) -> int:
        with self._lock:
            sess = self._sessions.get(sid) or {}
            return int(sess.get("priority", 0) or 0)

    def has_session(self, sid: str) -> bool:
        with self._lock:
            return sid in self._sessions

    def session_of(self, job_id: str) -> Optional[str]:
        """The session that holds ``job_id``, or None."""
        with self._lock:
            return next((sid for sid, sess in self._sessions.items()
                         if job_id in sess["jobs"]), None)

    # ---------------- jobs ----------------

    def has_job(self, sid: str, job_id: str) -> bool:
        with self._lock:
            sess = self._sessions.get(sid)
            return bool(sess and job_id in sess["jobs"])

    def create_job(
        self,
        sid: str,
        job_id: str,
        payload: Dict[str, Any],
        subtasks: List[Dict[str, Any]],
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        record = {
            "job_id": job_id,
            "payload": json_safe(payload),
            "created_at": time.time(),
            "total_subtasks": len(subtasks),
            "completed_subtasks": 0,
            "failed_subtasks": 0,
            "pruned_subtasks": 0,
            "diverged_subtasks": 0,
            "status": "pending",
            "subtasks": {
                st["subtask_id"]: {"spec": json_safe(st), "status": "pending", "result": None}
                for st in subtasks
            },
            "metadata": json_safe(metadata or {}),
            "result": None,
        }
        with self._lock:
            self._require_session(sid)["jobs"][job_id] = record
        self._journal({"op": "create_job", "sid": sid, "record": record})

    def update_subtask(
        self,
        sid: str,
        job_id: str,
        subtask_id: str,
        status: str,
        result: Optional[Dict[str, Any]] = None,
    ) -> None:
        result = json_safe(result)
        with self._lock:
            job = self._require_job(sid, job_id)
            self._apply_subtask_update(job, job["subtasks"][subtask_id], status, result)
        self._journal(
            {
                "op": "update_subtask",
                "sid": sid,
                "jid": job_id,
                "stid": subtask_id,
                "status": status,
                "attempt": int((result or {}).get("attempt") or 0),
                "result": result,
            }
        )

    @staticmethod
    def _apply_subtask_update(job, sub, status: str, result) -> None:
        """One subtask transition, shared by the live path and journal
        replay so both count identically. Terminal statuses count once
        toward completion; ``promoted`` stores the intermediate result
        without counting. Any result carrying an ``asha`` block is appended
        to the subtask's ``rung_history``, the record a restarted
        coordinator rebuilds rung state from."""
        prev = sub["status"]
        sub["status"] = status
        if result is not None:
            sub["result"] = result
            sub["attempt"] = int(result.get("attempt") or 0)
            if result.get("asha"):
                sub.setdefault("rung_history", []).append(dict(result["asha"]))
        if status in SUBTASK_TERMINAL_STATUSES and prev not in SUBTASK_TERMINAL_STATUSES:
            key = {"completed": "completed_subtasks", "pruned": "pruned_subtasks",
                   "diverged": "diverged_subtasks"}.get(status, "failed_subtasks")
            job[key] = job.get(key, 0) + 1
        done = _done(job)
        if done < job["total_subtasks"]:
            job["status"] = f"{100.0 * done / job['total_subtasks']:.1f}%"

    def record_curve(self, sid: str, job_id: str, subtask_id: str, curve: Dict[str, Any],
                     rung: int = 0, attempt: int = 0, diverged: bool = False) -> None:
        """Journal a rung-boundary learning curve (the fifth journal op).
        The coordinator's CurveStore is in memory only; a restarted
        coordinator reads these entries back (``drain_replayed_curves``)."""
        if not self._journal_path:
            return  # nothing to write: skip the JSON-safe copy of the curve
        self._journal({
            "op": "curve", "sid": sid, "jid": job_id, "stid": subtask_id,
            "rung": int(rung or 0), "attempt": int(attempt or 0),
            "diverged": bool(diverged), "curve": json_safe(curve),
        })

    def drain_replayed_curves(self) -> List[Dict[str, Any]]:
        """Hand the replayed ``curve`` entries to the caller exactly once."""
        with self._lock:
            out = self._replayed_curves
            self._replayed_curves = []
        return out

    def set_search_state(self, sid: str, job_id: str, summary: Dict[str, Any]) -> None:
        """Attach the live rung-state summary (AshaController.summary) to
        the job for progress readers. Derived state, rebuilt from
        ``rung_history``, so deliberately not journaled."""
        with self._lock:
            self._require_job(sid, job_id)["search"] = json_safe(summary)

    def finalize_job(self, sid: str, job_id: str, result: Dict[str, Any]) -> None:
        result = json_safe(result)
        with self._lock:
            job = self._require_job(sid, job_id)
            job["result"] = result
            job["status"] = _final_status(result)
            job["completion_time"] = time.time()
            event = self._done_events.pop((sid, job_id), None)
            completion_time = job["completion_time"]
        try:
            self._journal(
                {
                    "op": "finalize_job",
                    "sid": sid,
                    "jid": job_id,
                    "result": result,
                    "completion_time": completion_time,
                }
            )
        finally:
            if event is not None:
                event.set()

    def wait_job(self, sid: str, job_id: str, timeout: Optional[float] = None) -> bool:
        """Block until the job is finalized; False on timeout."""
        with self._lock:
            job = self._require_job(sid, job_id)
            if job["status"] in TERMINAL_STATUSES:
                return True
            event = self._done_events.setdefault((sid, job_id), threading.Event())
        return event.wait(timeout)

    def get_job(self, sid: str, job_id: str) -> Dict[str, Any]:
        with self._lock:
            return json.loads(json.dumps(self._require_job(sid, job_id)))

    def job_progress(self, sid: str, job_id: str) -> Dict[str, Any]:
        with self._lock:
            job = self._require_job(sid, job_id)
            done = _done(job)
            out = {
                "job_id": job.get("job_id", job_id),
                "job_status": job["status"],
                "tasks_completed": done,
                "tasks_pending": job["total_subtasks"] - done,
                "tasks_failed": job["failed_subtasks"],
                # adaptive search and the watchdog: non-failure terminals
                "tasks_pruned": job.get("pruned_subtasks", 0),
                "tasks_diverged": job.get("diverged_subtasks", 0),
                "total_subtasks": job["total_subtasks"],
                "job_result": job["result"] if job["status"] in TERMINAL_STATUSES else None,
            }
            if job.get("search") is not None:
                out["search"] = json.loads(json.dumps(job["search"]))
            return out

    def subtask_results(self, sid: str, job_id: str) -> List[Dict[str, Any]]:
        with self._lock:
            job = self._require_job(sid, job_id)
            return [
                json.loads(json.dumps(sub["result"]))
                for sub in job["subtasks"].values()
                if sub["result"] is not None
            ]

    # ---------------- internals ----------------

    def _require_session(self, sid: str) -> Dict[str, Any]:
        if sid not in self._sessions:
            raise KeyError(f"Invalid session id: {sid}")
        return self._sessions[sid]

    def _require_job(self, sid: str, job_id: str) -> Dict[str, Any]:
        jobs = self._require_session(sid)["jobs"]
        if job_id not in jobs:
            raise KeyError(f"Invalid job id: {job_id}")
        return jobs[job_id]

    def _journal(self, entry: Dict[str, Any]) -> None:
        if not self._journal_path:
            return
        with self._lock:
            with open(self._journal_path, "a") as f:
                f.write(json.dumps(json_safe(entry)) + "\n")

    def _replay(self) -> None:
        if not os.path.exists(self._journal_path):
            return
        ends_with_newline = True
        with open(self._journal_path) as f:
            for line in f:
                ends_with_newline = line.endswith("\n")
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    # a torn write: losing one op beats losing the store
                    self.replay_skipped += 1
                    continue
                if self._apply_entry(e):
                    op = str(e.get("op"))
                    self.replay_ops[op] = self.replay_ops.get(op, 0) + 1
                else:
                    self.replay_skipped += 1
        if not ends_with_newline:
            # terminate a torn last line so the next append starts clean
            try:
                with open(self._journal_path, "a") as f:
                    f.write("\n")
            except OSError:
                pass

    def _apply_entry(self, e: Dict[str, Any]) -> bool:
        """Apply one journal entry; False when it is unknown or refers to
        state a truncated journal never created. Never raises."""
        op = e.get("op")
        try:
            if op == "create_session":
                self._sessions.setdefault(
                    e["sid"], {"created_at": time.time(), "jobs": {},
                               "priority": int(e.get("priority", 0) or 0)})
            elif op == "create_job":
                self._sessions.setdefault(
                    e["sid"], {"created_at": time.time(), "jobs": {}}
                )["jobs"][e["record"]["job_id"]] = e["record"]
            elif op == "update_subtask":
                job = self._sessions[e["sid"]]["jobs"][e["jid"]]
                self._apply_subtask_update(
                    job, job["subtasks"][e["stid"]], e["status"], e.get("result")
                )
            elif op == "curve":
                # a truncated journal may hold a curve of a job whose
                # create_job entry was torn away
                if e["jid"] not in self._sessions[e["sid"]]["jobs"]:
                    return False
                if not isinstance(e.get("curve"), dict):
                    return False
                self._replayed_curves.append({
                    "sid": e["sid"], "jid": e["jid"], "stid": e["stid"],
                    "rung": int(e.get("rung", 0) or 0),
                    "attempt": int(e.get("attempt", 0) or 0),
                    "diverged": bool(e.get("diverged")), "curve": e["curve"],
                })
            elif op == "finalize_job":
                job = self._sessions[e["sid"]]["jobs"][e["jid"]]
                job["result"] = e["result"]
                job["status"] = _final_status(e["result"])
                if e.get("completion_time") is not None:
                    job["completion_time"] = e["completion_time"]
            else:
                return False
        except (KeyError, TypeError, ValueError):
            return False
        return True
