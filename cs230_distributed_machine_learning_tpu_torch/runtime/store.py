"""In-memory, journaled job/session state store.

Port of the JAX package's ``runtime/store.py``: plain dicts guarded by one
lock, plus an append-only JSONL journal in the same format (``jobs.jsonl``,
ops ``create_session`` / ``create_job`` / ``update_subtask`` /
``subtask_attempt`` / ``place`` / ``curve`` / ``finalize_job``), so a
restarted coordinator reads back the jobs it ran, their learning curves,
and for a scheduled job each subtask's attempt budget and placement, and
resumes the unfinished ones.

The sharded control plane's ops ride the same journal: ``mesh_gen`` (the
placement engine's reshard counter), ``migrate_out`` (the donor's
forwarding stamp), ``migrate_in`` (the recipient's adopted record, written
before the donor stamps) and ``steal`` (a donor-side tombstone for a
queued subtask granted to a thief shard). Replay is total: no truncation
point raises.

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

#: job statuses past which no further transitions happen.
#: ``completed_with_failures`` is the scheduled runtime's quarantine
#: contract: the job finished with partial results and a ``failed_subtasks``
#: report instead of stalling on a poisoned subtask.
TERMINAL_STATUSES = ("completed", "failed", "completed_with_failures")

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
    result = result or {}
    if result.get("status") == "failed":
        return "failed"
    if result.get("failed_subtasks"):
        return "completed_with_failures"
    return "completed"


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
        self.replay_seconds = 0.0
        #: highest journaled mesh generation: a recovered coordinator's
        #: placement engine resumes its counter from it
        self.mesh_generation = 0
        #: forwarding stamps: job_id -> destination shard of the jobs this
        #: store migrated out (their job routes answer 409 moved)
        self._migrated: Dict[str, int] = {}
        #: job ids adopted from a donor shard; they keep the donor's stamp
        self._adopted: set = set()
        #: donor-side steal tombstones: subtask_id -> grant info. While one
        #: is live the donor never re-dispatches the subtask; the next
        #: result clears it, or the steal lease reclaims it
        self.steal_tombstones: Dict[str, Dict[str, Any]] = {}
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

    def jobs_overview(self) -> List[Dict[str, Any]]:
        """One summary per job across the sessions, newest first (``GET
        /jobs``)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for sid, sess in self._sessions.items():
                for jid, job in sess["jobs"].items():
                    payload = job.get("payload") or {}
                    out.append({
                        "session_id": sid,
                        "job_id": jid,
                        "status": job.get("status"),
                        "model_type": (payload.get("model_details") or {}).get("model_type"),
                        "dataset_id": payload.get("dataset_id"),
                        "total_subtasks": job.get("total_subtasks"),
                        "completed_subtasks": job.get("completed_subtasks"),
                        "failed_subtasks": job.get("failed_subtasks"),
                        "pruned_subtasks": job.get("pruned_subtasks", 0),
                        "diverged_subtasks": job.get("diverged_subtasks", 0),
                        "created_at": job.get("created_at"),
                        "completion_time": job.get("completion_time"),
                        # rebalancing provenance: where the job went
                        # (donor view) / came from (recipient view)
                        "migrated_to": job.get("migrated_to"),
                        "migrated_from": job.get("migrated_from"),
                    })
        out.sort(key=lambda j: j.get("created_at") or 0, reverse=True)
        return out

    def hint_shape(self, sid: str, job_id: str) -> Dict[str, Any]:
        """The prewarm hint's extract of one job: the first subtask's
        parameters, the payload's scalar train_params and the subtask
        count, without the whole-job deep copy of ``get_job``. Raises
        KeyError for unknown ids."""
        with self._lock:
            job = self._require_job(sid, job_id)
            first = next(iter((job.get("subtasks") or {}).values()), None)
            params = ((first or {}).get("spec") or {}).get("parameters") or {}
            train_params = (job.get("payload") or {}).get("train_params") or {}
            return {
                "parameters": json.loads(json.dumps(params)),
                "train_params": {k: v for k, v in train_params.items()
                                 if isinstance(v, (str, int, float, bool, type(None)))},
                "n_trials": int(job.get("total_subtasks") or 1),
            }

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
            # any delivered result retires a steal tombstone
            self.steal_tombstones.pop(subtask_id, None)
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

    def record_attempt(self, sid: str, job_id: str, subtask_id: str, attempt: int,
                       failures: int = 0, excluded: Optional[List[str]] = None) -> None:
        """Journal a subtask attempt (lease reclaim, failure retry, requeue,
        speculation) into its spec, so a replayed coordinator resumes with
        the retry budget and the excluded workers intact."""
        with self._lock:
            spec = self._require_job(sid, job_id)["subtasks"][subtask_id]["spec"]
            spec["attempt"] = int(attempt)
            spec["failures"] = int(failures)
            spec["excluded_workers"] = list(excluded or [])
        self._journal({"op": "subtask_attempt", "sid": sid, "jid": job_id,
                       "stid": subtask_id, "attempt": int(attempt),
                       "failures": int(failures), "excluded": list(excluded or [])})

    def record_placement(self, sid: str, job_id: str, subtask_id: str, worker_id: str,
                         attempt: int = 0, lease_deadline: Optional[float] = None) -> None:
        """Journal a placement and its lease into the spec. A replayed
        coordinator then tells dispatched in-flight subtasks (a fresh
        attempt before requeueing, so a zombie worker's late failure is
        stale) from never-dispatched ones."""
        with self._lock:
            spec = self._require_job(sid, job_id)["subtasks"][subtask_id]["spec"]
            spec["placed_worker"] = worker_id
            spec["placed_attempt"] = int(attempt or 0)
            if lease_deadline is not None:
                spec["lease_deadline"] = float(lease_deadline)
        self._journal({"op": "place", "sid": sid, "jid": job_id, "stid": subtask_id,
                       "worker": worker_id, "attempt": int(attempt or 0),
                       "lease_deadline": lease_deadline})

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

    def record_mesh_generation(self, generation: int, reason: Optional[str] = None) -> None:
        """Journal a mesh-generation bump (a worker's join, death or
        eviction) so recovery resumes the counter instead of resetting it."""
        with self._lock:
            self.mesh_generation = max(self.mesh_generation, int(generation or 0))
        self._journal({"op": "mesh_gen", "generation": int(generation or 0), "reason": reason})

    # ---------------- cross-shard rebalancing ----------------
    # The journal is the migration transport: ``migrate_in`` lands the
    # whole record on the recipient before the donor stamps
    # ``migrate_out``, so a crash between the two leaves at most a
    # duplicated (deduped) owner, never a lost job.

    def migrated_to(self, job_id: str) -> Optional[int]:
        """Destination shard of a job this store migrated away, or None."""
        return self._migrated.get(job_id)

    def record_migrate_out(self, sid: str, job_id: str, dest_shard: int) -> None:
        """Stamp a job as migrated to ``dest_shard``. The record stays (its
        routes answer 409 moved) but the job leaves ``unfinished_jobs`` and
        ``unfinished_counts``: a restarted donor never resumes it."""
        with self._lock:
            job = self._require_job(sid, job_id)
            job["migrated_to"] = int(dest_shard)
            self._migrated[job_id] = int(dest_shard)
            event = self._done_events.pop((sid, job_id), None)
        self._journal({"op": "migrate_out", "sid": sid, "jid": job_id, "dest": int(dest_shard)})
        if event is not None:
            event.set()

    def import_job(self, sid: str, record: Dict[str, Any],
                   source_shard: Optional[int] = None) -> None:
        """Install a whole job record exported by a donor shard; the journal
        entry carries the record, so a replay restores the same state."""
        record = json_safe(record)
        record["migrated_from"] = source_shard
        record.pop("migrated_to", None)
        with self._lock:
            self._require_session(sid)["jobs"][record["job_id"]] = record
            self._adopted.add(record["job_id"])
        self._journal({"op": "migrate_in", "sid": sid, "record": record,
                       "source_shard": source_shard})

    def is_adopted_job(self, job_id: str) -> bool:
        """True for ids adopted through ``import_job``: they wear the
        donor's shard stamp and must not be re-stamped."""
        return job_id in self._adopted

    def record_steal(self, sid: str, job_id: str, subtask_id: str, thief_shard: int,
                     attempt: int) -> None:
        """Tombstone a queued subtask granted to a thief shard, with the
        fenced attempt the thief runs. Replay restores it with a fresh
        lease clock."""
        with self._lock:
            self.steal_tombstones[subtask_id] = {
                "sid": sid, "jid": job_id, "thief": int(thief_shard),
                "attempt": int(attempt), "ts": time.time(),
            }
        self._journal({"op": "steal", "sid": sid, "jid": job_id, "stid": subtask_id,
                       "thief": int(thief_shard), "attempt": int(attempt)})

    def clear_steal(self, subtask_id: str) -> None:
        """Drop a steal tombstone (result arrived, or lease reclaimed). Not
        journaled: the matching update or attempt entry encodes it."""
        if not self.steal_tombstones:
            return
        with self._lock:
            self.steal_tombstones.pop(subtask_id, None)

    def lookup_specs(self, subtask_ids) -> Dict[str, Dict[str, Any]]:
        """Live (non-terminal, not migrated) subtask ids to ``{session_id,
        job_id, spec, metadata}`` copies, in one lock pass."""
        wanted = set(subtask_ids)
        out: Dict[str, Dict[str, Any]] = {}
        if not wanted:
            return out
        with self._lock:
            for sid, sess in self._sessions.items():
                for jid, job in sess["jobs"].items():
                    if job.get("migrated_to") is not None or job["status"] in TERMINAL_STATUSES:
                        continue
                    for stid in wanted & set(job["subtasks"]):
                        sub = job["subtasks"][stid]
                        if sub["status"] in SUBTASK_TERMINAL_STATUSES:
                            continue
                        out[stid] = {
                            "session_id": sid, "job_id": jid,
                            "spec": json.loads(json.dumps(sub["spec"])),
                            "metadata": json.loads(json.dumps(job.get("metadata") or {})),
                        }
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

    def unfinished_jobs(self) -> List[tuple]:
        """(sid, job_id) of the jobs not yet finalized: after a journal
        replay, the in-flight jobs a restarted coordinator resumes. A job
        migrated out is the destination shard's."""
        with self._lock:
            return [(sid, jid) for sid, sess in self._sessions.items()
                    for jid, job in sess["jobs"].items()
                    if job["status"] not in TERMINAL_STATUSES
                    and job.get("migrated_to") is None]

    def unfinished_counts(self) -> Dict[str, Any]:
        """Admission control's inputs in one lock hold: unfinished jobs
        (in all and by session) and their pending subtasks."""
        per_session: Dict[str, int] = {}
        jobs = pending = 0
        with self._lock:
            for sid, sess in self._sessions.items():
                for job in sess["jobs"].values():
                    if job["status"] in TERMINAL_STATUSES or job.get("migrated_to") is not None:
                        continue
                    jobs += 1
                    per_session[sid] = per_session.get(sid, 0) + 1
                    pending += max(int(job["total_subtasks"]) - _done(job), 0)
        return {"jobs": jobs, "per_session": per_session, "pending_subtasks": pending}

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
        t0 = time.time()
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
        self.replay_seconds = time.time() - t0

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
                self.steal_tombstones.pop(e["stid"], None)
            elif op == "subtask_attempt":
                spec = self._sessions[e["sid"]]["jobs"][e["jid"]]["subtasks"][e["stid"]]["spec"]
                spec["attempt"] = int(e.get("attempt", 0) or 0)
                spec["failures"] = int(e.get("failures", 0) or 0)
                spec["excluded_workers"] = list(e.get("excluded") or [])
            elif op == "place":
                spec = self._sessions[e["sid"]]["jobs"][e["jid"]]["subtasks"][e["stid"]]["spec"]
                spec["placed_worker"] = e.get("worker")
                spec["placed_attempt"] = int(e.get("attempt", 0) or 0)
                if e.get("lease_deadline") is not None:
                    spec["lease_deadline"] = float(e["lease_deadline"])
            elif op == "mesh_gen":
                self.mesh_generation = max(self.mesh_generation,
                                           int(e.get("generation", 0) or 0))
            elif op == "migrate_out":
                job = self._sessions[e["sid"]]["jobs"][e["jid"]]
                job["migrated_to"] = int(e.get("dest", 0) or 0)
                self._migrated[e["jid"]] = int(e.get("dest", 0) or 0)
            elif op == "migrate_in":
                self._sessions.setdefault(
                    e["sid"], {"created_at": time.time(), "jobs": {}, "priority": 0}
                )["jobs"][e["record"]["job_id"]] = e["record"]
                self._adopted.add(e["record"]["job_id"])
            elif op == "steal":
                # a fresh lease clock: the thief gets a whole lease after a
                # donor restart
                self.steal_tombstones[e["stid"]] = {
                    "sid": e["sid"], "jid": e["jid"], "thief": int(e.get("thief", 0) or 0),
                    "attempt": int(e.get("attempt", 0) or 0), "ts": time.time(),
                }
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
