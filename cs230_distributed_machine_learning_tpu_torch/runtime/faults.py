"""Attempt ledger: shared fault-tolerance accounting for subtask attempts.

A copy of the JAX package's ``runtime/faults.py`` (framework-free).

The fault-tolerance layer (docs/ROBUSTNESS.md) runs the same subtask more
than once — lease reclaims off hung workers, bounded retries after
failures, speculative backup copies — so somebody has to own the facts
that make re-execution safe:

- the **attempt counter**: a monotonically increasing id stamped into
  every dispatched copy of a subtask. Result ingest dedups on it (a
  FAILED report from a superseded attempt must not burn retry budget) and
  the coordinator journals it (``JobStore.record_attempt``) so a replayed
  coordinator resumes with budgets intact.
- the **failure budget**: how many executions of this subtask ended in a
  terminal failure or an expired lease. At ``retry_max_attempts`` the
  subtask is quarantined instead of retried.
- **excluded-worker memory**: a subtask is never retried on the worker
  that just failed it or sat on its lease (mirroring excluded_runner
  semantics from self-hosted runner pools). Placement treats the list as
  a preference, not a hard gate — liveness beats affinity when only
  excluded workers remain.
- the **device-loss correlation**: a subtask that has killed
  ``poison_kill_threshold`` worker backends is poisoned and quarantined
  without further retries, so one bad trial cannot chew through the pool.

The ledger is shared by the :class:`~.scheduler.PlacementEngine` (lease
reclaims, dead-worker requeues, speculation) and the coordinator's
result-collection loop (failure retries, quarantine) via the owning
:class:`~.cluster.ClusterRuntime`. All methods are thread-safe; the
``on_attempt`` hook (installed by the coordinator) fires OUTSIDE the
internal lock so it may take the job-store lock freely.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

from ..obs import record_event
from ..utils.logging import get_logger

logger = get_logger("tpuml.faults")

#: hook signature: (task_dict, AttemptEntry snapshot, reason) -> None
AttemptHook = Callable[[Dict[str, Any], "AttemptEntry", str], None]


@dataclasses.dataclass
class AttemptEntry:
    """Per-subtask fault accounting (see module docstring)."""

    subtask_id: str
    #: highest attempt id issued (0 = the initial dispatch)
    attempt: int = 0
    #: executions that ended in a terminal failure or a reclaimed lease
    failures: int = 0
    #: worker backends this subtask's executions have killed (DeviceLost)
    device_losses: int = 0
    #: workers that failed/hung this subtask — avoided on later attempts
    excluded: List[str] = dataclasses.field(default_factory=list)
    #: a speculative duplicate has been launched (at most one per subtask)
    speculated: bool = False
    #: a terminal result was accepted; later copies are dropped, not re-run
    done: bool = False


class AttemptLedger:
    def __init__(self, on_attempt: Optional[AttemptHook] = None):
        self._lock = threading.Lock()
        self._entries: Dict[str, AttemptEntry] = {}
        #: journaling hook, installed by the coordinator (store binding)
        self.on_attempt = on_attempt

    # ---------------- internals ----------------

    def _entry_locked(self, subtask_id: str, attempt: int = 0) -> AttemptEntry:
        e = self._entries.get(subtask_id)
        if e is None:
            e = AttemptEntry(subtask_id=subtask_id, attempt=int(attempt or 0))
            self._entries[subtask_id] = e
        return e

    @staticmethod
    def _snapshot(e: AttemptEntry) -> AttemptEntry:
        return dataclasses.replace(e, excluded=list(e.excluded))

    # ---------------- lifecycle ----------------

    def seed(self, spec: Dict[str, Any]) -> AttemptEntry:
        """Adopt a subtask spec (possibly replayed from a journal). Specs
        from journals that predate the attempt schema carry none of the
        fields — every read defaults to a zeroed budget."""
        stid = spec["subtask_id"]
        with self._lock:
            e = self._entry_locked(stid, spec.get("attempt", 0))
            e.attempt = max(e.attempt, int(spec.get("attempt", 0) or 0))
            e.failures = max(e.failures, int(spec.get("failures", 0) or 0))
            for w in spec.get("excluded_workers") or []:
                if w not in e.excluded:
                    e.excluded.append(w)
            return self._snapshot(e)

    def forget(self, subtask_ids) -> None:
        """Drop entries for a finished job (bounds the ledger's size)."""
        with self._lock:
            for stid in subtask_ids:
                self._entries.pop(stid, None)

    # ---------------- attempts ----------------

    def next_attempt(
        self,
        task: Dict[str, Any],
        exclude_worker: Optional[str] = None,
        reason: str = "retry",
        speculative: bool = False,
    ) -> AttemptEntry:
        """Issue the next attempt id for ``task`` and stamp it in place
        (``attempt``, ``excluded_workers``, and ``speculative`` when set).
        Fires the ``on_attempt`` journal hook."""
        stid = task["subtask_id"]
        with self._lock:
            e = self._entry_locked(stid, task.get("attempt", 0))
            e.attempt = max(e.attempt, int(task.get("attempt", 0) or 0)) + 1
            if exclude_worker and exclude_worker not in e.excluded:
                e.excluded.append(exclude_worker)
            if speculative:
                e.speculated = True
            task["attempt"] = e.attempt
            task["excluded_workers"] = list(e.excluded)
            if speculative:
                task["speculative"] = True
            snap = self._snapshot(e)
        # flight-recorder breadcrumb for EVERY re-dispatch stamp — lease
        # reclaims, failure retries, dead-worker requeues, speculation —
        # since every path funnels through here (docs/OBSERVABILITY.md
        # "Flight recorder")
        record_event(
            "attempt",
            job_id=task.get("job_id"), subtask_id=stid,
            attempt=snap.attempt, reason=reason,
            excluded_worker=exclude_worker, failures=snap.failures,
            excluded=list(snap.excluded), speculative=bool(speculative),
        )
        hook = self.on_attempt
        if hook is not None:
            try:
                hook(task, snap, reason)
            except Exception:  # noqa: BLE001 — journaling must not kill dispatch
                logger.exception("Attempt journal hook failed for %s", stid)
        return snap

    def record_failure(
        self, subtask_id: str, worker_id: Optional[str] = None
    ) -> AttemptEntry:
        """Count one failed execution against the subtask's budget and
        remember the worker it failed on."""
        with self._lock:
            e = self._entry_locked(subtask_id)
            e.failures += 1
            if worker_id and worker_id not in e.excluded:
                e.excluded.append(worker_id)
            return self._snapshot(e)

    def note_device_loss(self, subtask_id: str) -> int:
        """Count one killed worker backend against the subtask; returns the
        new kill count (the poison correlation input)."""
        with self._lock:
            e = self._entry_locked(subtask_id)
            e.device_losses += 1
            return e.device_losses

    # ---------------- queries ----------------

    def get(self, subtask_id: str) -> Optional[AttemptEntry]:
        with self._lock:
            e = self._entries.get(subtask_id)
            return self._snapshot(e) if e is not None else None

    def is_stale(self, subtask_id: str, attempt: int) -> bool:
        """True when ``attempt`` has been superseded by a newer one — its
        failure must not consume budget (the newer attempt owns the
        outcome now)."""
        with self._lock:
            e = self._entries.get(subtask_id)
            return e is not None and int(attempt or 0) < e.attempt

    def mark_done(self, subtask_id: str) -> None:
        """A terminal result was accepted: later lease expiries/requeues of
        surviving duplicate copies release bookkeeping without re-running."""
        with self._lock:
            self._entry_locked(subtask_id).done = True

    def is_done(self, subtask_id: str) -> bool:
        with self._lock:
            e = self._entries.get(subtask_id)
            return e is not None and e.done

    def was_speculated(self, subtask_id: str) -> bool:
        with self._lock:
            e = self._entries.get(subtask_id)
            return e is not None and e.speculated
