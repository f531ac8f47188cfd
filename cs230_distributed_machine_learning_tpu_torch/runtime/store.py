"""In-memory, journaled job/session state store.

Port of the direct-mode subset of the JAX package's ``runtime/store.py``:
plain dicts guarded by one lock, plus an append-only JSONL journal in the
same format (``jobs.jsonl``, ops ``create_session`` / ``create_job`` /
``update_subtask`` / ``finalize_job``), so a restarted coordinator can read
back the jobs it ran.

Status semantics: ``status`` is "pending" until the first subtask ends,
then a percentage string, then "completed"; failed subtasks count toward
completion.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..utils.serialization import json_safe

#: job and subtask statuses past which no further transitions happen
TERMINAL_STATUSES = ("completed", "failed")


def _final_status(result) -> str:
    return "failed" if (result or {}).get("status") == "failed" else "completed"


class JobStore:
    def __init__(self, journal_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._done_events: Dict[tuple, threading.Event] = {}
        self._journal_path = None
        if journal_dir:
            os.makedirs(journal_dir, exist_ok=True)
            self._journal_path = os.path.join(journal_dir, "jobs.jsonl")
            self._replay()

    # ---------------- sessions ----------------

    def create_session(self, session_id: Optional[str] = None) -> str:
        sid = session_id or str(uuid.uuid4())
        with self._lock:
            self._sessions.setdefault(sid, {"created_at": time.time(), "jobs": {}})
        self._journal({"op": "create_session", "sid": sid, "priority": 0})
        return sid

    def has_session(self, sid: str) -> bool:
        with self._lock:
            return sid in self._sessions

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
        replay so both count identically."""
        prev = sub["status"]
        sub["status"] = status
        if result is not None:
            sub["result"] = result
        if status in TERMINAL_STATUSES and prev not in TERMINAL_STATUSES:
            key = "completed_subtasks" if status == "completed" else "failed_subtasks"
            job[key] += 1
        done = job["completed_subtasks"] + job["failed_subtasks"]
        if done < job["total_subtasks"]:
            job["status"] = f"{100.0 * done / job['total_subtasks']:.1f}%"

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
            done = job["completed_subtasks"] + job["failed_subtasks"]
            return {
                "job_id": job.get("job_id", job_id),
                "job_status": job["status"],
                "tasks_completed": done,
                "tasks_pending": job["total_subtasks"] - done,
                "tasks_failed": job["failed_subtasks"],
                "total_subtasks": job["total_subtasks"],
                "job_result": job["result"] if job["status"] in TERMINAL_STATUSES else None,
            }

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
        with open(self._journal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    self._apply_entry(json.loads(line))
                except json.JSONDecodeError:
                    continue  # a torn write: losing one op beats losing the store

    def _apply_entry(self, e: Dict[str, Any]) -> None:
        """Apply one journal entry; skip it when it is unknown or refers to
        state a truncated journal never created. Never raises."""
        op = e.get("op")
        try:
            if op == "create_session":
                self._sessions.setdefault(e["sid"], {"created_at": time.time(), "jobs": {}})
            elif op == "create_job":
                self._sessions.setdefault(
                    e["sid"], {"created_at": time.time(), "jobs": {}}
                )["jobs"][e["record"]["job_id"]] = e["record"]
            elif op == "update_subtask":
                job = self._sessions[e["sid"]]["jobs"][e["jid"]]
                self._apply_subtask_update(
                    job, job["subtasks"][e["stid"]], e["status"], e.get("result")
                )
            elif op == "finalize_job":
                job = self._sessions[e["sid"]]["jobs"][e["jid"]]
                job["result"] = e["result"]
                job["status"] = _final_status(e["result"])
                if e.get("completion_time") is not None:
                    job["completion_time"] = e["completion_time"]
        except (KeyError, TypeError, ValueError):
            pass
