"""Placement engine: learned-runtime, load/memory/speed-aware scheduling.

A copy of the JAX package's ``runtime/scheduler.py`` (framework-free).

Capability parity with the reference scheduler service
(``aws-prod/scheduler/scheduler_service.py``), re-homed from Kafka-keyed
containers to mesh executors:

- ``WorkerState`` (scheduler_service.py:91-104): queued-runtime load,
  memory load vs capacity, EMA speed factor, heartbeat stamp, task queue.
- placement (scheduler_service.py:167-191): eligible = fits in memory
  (fallback: all, with a warning); score = effective_finish_time +
  est_runtime / max(speed, 1e-3); pick min.
- feedback (scheduler_service.py:295-351): on a metrics message, decrement
  load/memory, update ``speed_factor = clamp(0.2..5, 0.8*old +
  0.2*(est/actual))``, feed the runtime predictor.
- failure detection (scheduler_service.py:205-247): periodic sweep marks
  workers dead after ``dead_after_s`` of heartbeat silence and requeues
  their queued tasks onto survivors; ``unsubscribe`` does the same
  gracefully (scheduler.py:120-139). Elastic join assigns monotonically
  increasing ids (scheduler_service.py:157-165).

Beyond the reference, the fault-tolerance layer (docs/ROBUSTNESS.md):

- **leases**: every placed subtask carries a deadline derived from the
  runtime predictor's estimate (x ``lease_factor``, floored); the sweep
  reclaims expired leases from LIVE but hung workers — the strictly
  stronger form of the dead-worker detection above.
- **speculative execution**: an in-flight subtask whose age exceeds the
  peer-median batch EWMA x ``straggler_factor`` gets ONE duplicate on an
  idle worker (Dean & Ghemawat's backup tasks); the coordinator's
  result-ingest dedups by attempt id, first terminal result wins.
- **circuit breaker**: a worker whose windowed failure ratio trips
  ``breaker_failure_ratio`` is demoted to half-open (probe tasks only —
  at most one in flight) and evicted after ``breaker_max_trips`` trips,
  upgrading the advisory straggler penalty into an enforced state
  machine.
All re-executions are accounted through the shared
:class:`~.faults.AttemptLedger` so attempt ids stay monotonic and
journaled.

The engine is transport-agnostic: it consumes/produces on the in-process
TopicBus (runtime/queue.py) locally, and the same message schema rides DCN
RPC for multi-host agents (runtime/agent.py).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..obs import (
    counter_inc,
    gauge_set,
    obs_enabled,
    observe,
    record_event,
    refresh_route_p99,
    span,
    timeseries_sample,
)
from ..utils.config import get_config
from ..utils.logging import get_logger
from .faults import AttemptLedger
from .predictor import RuntimePredictor

logger = get_logger("tpuml.scheduler")

TOPIC_TASKS = "tasks"
TOPIC_TRAIN = "train"
#: same name as cluster.TOPIC_RESULT — the sweep publishes synthetic
#: failed results here when a subtask exhausts its lease budget
TOPIC_RESULT = "result"


@dataclasses.dataclass
class WorkerState:
    worker_id: str
    mem_capacity_mb: float
    #: devices in this worker's mesh slice (reported at /subscribe) — the
    #: predictor-aware packing divisor: a trial batch parallelizes across
    #: the slice, so an N-device worker drains its queue ~N x faster and
    #: its placement score prices estimates per slice, not per process
    n_devices: int = 1
    #: mesh axis spec of the slice ({axis: size}), advisory/observability
    mesh_shape: Optional[Dict[str, int]] = None
    load_seconds: float = 0.0
    mem_load_mb: float = 0.0
    speed_factor: float = 1.0
    last_heartbeat: float = dataclasses.field(default_factory=time.time)
    tasks_queue: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # per-task bookkeeping for feedback decrements
    task_est: Dict[str, float] = dataclasses.field(default_factory=dict)
    task_mem: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: per-task lease deadline (absolute time); expired leases on a LIVE
    #: worker are reclaimed by the sweep (docs/ROBUSTNESS.md)
    task_lease: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: per-task placement timestamp — the speculation age signal
    task_placed_at: Dict[str, float] = dataclasses.field(default_factory=dict)
    alive: bool = True
    # ---- circuit breaker (closed -> half_open -> evicted) ----
    breaker_state: str = "closed"
    breaker_trips: int = 0
    #: outcome window since the last breaker transition
    window_ok: int = 0
    window_failed: int = 0
    # ---- health telemetry (docs/OBSERVABILITY.md "Worker health") ----
    #: EWMA of this worker's batch wall time (None until the first batch)
    ewma_batch_s: Optional[float] = None
    #: batches absorbed into the EWMA (the straggler-guard denominator:
    #: outcomes arrive per SUBTASK, so counting them would let one cold
    #: multi-subtask batch satisfy the min-batches guard)
    n_batches: int = 0
    #: subtask outcomes reported for this worker
    n_completed: int = 0
    n_failed: int = 0

    def effective_finish_time(self) -> float:
        return self.load_seconds / max(self.speed_factor, 1e-3)

    def slice_est(self, est: float) -> float:
        """Price an estimate per mesh slice: the trial engine shards a
        batch's trial axis across the worker's devices, so wall time
        divides by the slice width (the speed_factor EWMA then corrects
        whatever the ideal-scaling assumption gets wrong)."""
        return est / max(int(self.n_devices or 1), 1)

    def n_outcomes(self) -> int:
        return self.n_completed + self.n_failed

    def failure_ratio(self) -> float:
        total = self.n_outcomes()
        return self.n_failed / total if total else 0.0


class PlacementEngine:
    def __init__(
        self,
        bus=None,
        predictor: Optional[RuntimePredictor] = None,
        ledger: Optional[AttemptLedger] = None,
        worker_prefix: str = "",
    ):
        cfg = get_config().scheduler
        self.cfg = cfg
        self.bus = bus
        #: minted worker ids are ``<prefix>worker-<n>``; a coordinator
        #: shard sets its shard stamp here (runtime/sharding.worker_prefix)
        #: so front ends can route worker-plane requests statelessly
        self.worker_prefix = worker_prefix
        self.predictor = predictor or RuntimePredictor()
        #: attempt/exclusion/poison accounting, shared with the coordinator
        #: when a ClusterRuntime wires both to one ledger
        self.ledger = ledger if ledger is not None else AttemptLedger()
        #: called with a worker id the breaker evicted — the cluster hooks
        #: this to tear down the in-process worker / remote subscription
        self.on_evict: Optional[Callable[[str], None]] = None
        #: called AFTER a placement with (task, worker_id, lease_deadline)
        #: — the coordinator hooks this to journal placements + lease
        #: grants so a restarted process can tell dispatched in-flight
        #: subtasks from never-dispatched ones (docs/ROBUSTNESS.md
        #: "Coordinator recovery")
        self.on_place: Optional[
            Callable[[Dict[str, Any], str, Optional[float]], None]
        ] = None
        #: overload probe installed by the coordinator (admission control):
        #: True while the fleet is shedding optional work — speculation
        #: skips its launches first, before admission starts rejecting
        self.shed_check: Optional[Callable[[], bool]] = None
        #: elastic-fabric mesh generation (docs/ARCHITECTURE.md "Elastic
        #: trial fabric"): bumped whenever the fleet's device topology
        #: changes (worker join / death / eviction / unsubscribe). Every
        #: placement stamps the task with the current generation; the
        #: coordinator journals bumps (``on_mesh_change``) so recovery
        #: replays the generation instead of restarting at 0.
        self.mesh_generation = 0
        #: called with (generation, reason, snapshot) after each bump —
        #: the coordinator hooks this to journal the reshard
        self.on_mesh_change: Optional[
            Callable[[int, str, Dict[str, Any]], None]
        ] = None
        #: called at the end of every sweep, after the health/route-p99
        #: refresh and the time-series sample — the coordinator hooks its
        #: fleet-health tick here (capacity signals + alert evaluation,
        #: docs/OBSERVABILITY.md "Fleet health plane")
        self.on_sweep_end: Optional[Callable[[], None]] = None
        self._lock = threading.RLock()
        self.workers: Dict[str, WorkerState] = {}
        self._next_id = 0
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        #: workers currently flagged as stragglers (transition logging)
        self._flagged: set = set()

    # ---------------- registry (subscribe/heartbeat/unsubscribe) ----------------

    def subscribe(
        self,
        mem_capacity_mb: Optional[float] = None,
        worker_id: Optional[str] = None,
        n_devices: Optional[int] = None,
        mesh_shape: Optional[Dict[str, int]] = None,
    ) -> str:
        with self._lock:
            if worker_id is None:
                worker_id = f"{self.worker_prefix}worker-{self._next_id}"
                self._next_id += 1
            self.workers[worker_id] = WorkerState(
                worker_id=worker_id,
                mem_capacity_mb=mem_capacity_mb or self.cfg.default_mem_capacity_mb,
                n_devices=max(int(n_devices or 1), 1),
                mesh_shape=(
                    {str(k): int(v) for k, v in mesh_shape.items()}
                    if mesh_shape else None
                ),
            )
            logger.info(
                "Worker %s subscribed (%d-device slice)",
                worker_id, self.workers[worker_id].n_devices,
            )
            gauge_set("tpuml_workers_alive", len(self.workers))
        self._mesh_changed("join", worker_id)
        return worker_id

    def unsubscribe(self, worker_id: str) -> List[Dict[str, Any]]:
        """Remove a worker; requeue its queued tasks. Returns the requeued tasks."""
        with self._lock:
            state = self.workers.pop(worker_id, None)
            gauge_set("tpuml_workers_alive", len(self.workers))
        self._drop_worker_gauges(worker_id)
        if state is None:
            return []
        logger.info("Worker %s unsubscribed; requeueing %d tasks", worker_id, len(state.tasks_queue))
        self._mesh_changed("unsubscribe", worker_id)
        return self._requeue(state.tasks_queue, from_worker=worker_id)

    # ---------------- elastic mesh fabric ----------------

    def total_devices(self) -> int:
        """Devices across every live worker's mesh slice — the fleet's
        current data-plane width."""
        with self._lock:
            return sum(
                max(int(w.n_devices or 1), 1) for w in self.workers.values()
            )

    def _mesh_changed(self, reason: str, worker_id: str) -> None:
        """The fleet's device topology changed: bump the mesh generation,
        record the reshard, and notify the journal hook. In-flight work
        placed under the old generation is re-placed by the existing
        lease/requeue machinery with fresh attempt ids — a killed host's
        trials resume on the reshaped fleet without manual restart
        (docs/ARCHITECTURE.md "Elastic trial fabric")."""
        # bump AND emit under one lock hold: two concurrent topology
        # changes must publish their gauges/events/journal entries in
        # generation order, or the gauge could regress to the earlier
        # generation and the event stream would read out of order. The
        # emission targets (registry, recorder, store journal) never
        # call back into this engine, so no lock-ordering hazard.
        with self._lock:
            self.mesh_generation += 1
            gen = self.mesh_generation
            snapshot = {
                "n_workers": len(self.workers),
                "total_devices": self.total_devices(),
            }
            gauge_set("tpuml_mesh_generation", float(gen))
            gauge_set(
                "tpuml_mesh_devices_total", float(snapshot["total_devices"])
            )
            counter_inc("tpuml_mesh_reshards_total", reason=reason)
            record_event(
                "mesh.reshard", generation=gen, reason=reason,
                worker_id=worker_id, **snapshot,
            )
            hook = self.on_mesh_change
            if hook is not None:
                try:
                    hook(gen, reason, snapshot)
                except Exception:  # noqa: BLE001 — journaling must not block
                    logger.exception("Mesh-change journal hook failed")

    def heartbeat(self, worker_id: str) -> bool:
        with self._lock:
            state = self.workers.get(worker_id)
            if state is None:
                return False
            state.last_heartbeat = time.time()
            return True

    def worker_snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                wid: {
                    "load_seconds": w.load_seconds,
                    "mem_load_mb": w.mem_load_mb,
                    "mem_capacity_mb": w.mem_capacity_mb,
                    "speed_factor": w.speed_factor,
                    "last_heartbeat": w.last_heartbeat,
                    "queue_depth": len(w.tasks_queue),
                    "n_devices": w.n_devices,
                    "mesh_shape": w.mesh_shape,
                }
                for wid, w in self.workers.items()
            }

    def queue_snapshot(self) -> Dict[str, List[str]]:
        with self._lock:
            return {
                wid: [t.get("subtask_id", "?") for t in w.tasks_queue]
                for wid, w in self.workers.items()
            }

    def hot_families(self, top_n: int = 5) -> List[str]:
        """The runtime predictor's recently-hot model families — what the
        coordinator ships as the AOT-prewarm hint ranking when a worker
        registers (runtime/prewarm.py). [] for stub predictors without
        the surface (engine-level tests)."""
        hf = getattr(self.predictor, "hot_families", None)
        return hf(top_n=top_n) if hf is not None else []

    # ---------------- per-worker health ----------------

    def record_outcome(self, worker_id: str, ok: bool) -> None:
        """Count one subtask outcome against a worker — the failure-rate
        input. Fed by the cluster's result paths (in-process worker
        callbacks and remote /task_result ingest). Also drives the circuit
        breaker: closed -> half-open on a tripped windowed failure ratio,
        half-open -> closed on a successful probe, eviction after
        ``breaker_max_trips`` trips (docs/ROBUSTNESS.md)."""
        cfg = self.cfg
        evict = False
        transition = None  # (from_state, to_state, trips) for the recorder
        with self._lock:
            w = self.workers.get(worker_id)
            if w is None:
                return
            if ok:
                w.n_completed += 1
                w.window_ok += 1
            else:
                w.n_failed += 1
                w.window_failed += 1
            if cfg.breaker_failure_ratio <= 0:
                return
            if w.breaker_state == "half_open":
                if ok:
                    w.breaker_state = "closed"
                    w.window_ok = w.window_failed = 0
                    transition = ("half_open", "closed", w.breaker_trips)
                    gauge_set(
                        "tpuml_worker_breaker_state", 0.0, wid=worker_id
                    )
                    logger.info(
                        "Worker %s breaker closed (probe succeeded)", worker_id
                    )
                else:
                    w.breaker_trips += 1
                    w.window_ok = w.window_failed = 0
                    evict = w.breaker_trips >= cfg.breaker_max_trips
                    transition = ("half_open", "half_open", w.breaker_trips)
                    logger.warning(
                        "Worker %s breaker probe failed (trip %d/%d)",
                        worker_id, w.breaker_trips, cfg.breaker_max_trips,
                    )
            else:
                total = w.window_ok + w.window_failed
                # bounded window: decay (halve) the counters once the
                # window outgrows the trip threshold by 8x, so a long-
                # healthy history cannot drown out a recent failure streak
                # (1000 past successes must not require 1000 failures to
                # trip). Halving preserves the ratio.
                if total >= 8 * max(cfg.breaker_min_outcomes, 4):
                    w.window_ok //= 2
                    w.window_failed //= 2
                    total = w.window_ok + w.window_failed
                if (
                    total >= cfg.breaker_min_outcomes
                    and w.window_failed / total >= cfg.breaker_failure_ratio
                ):
                    w.breaker_state = "half_open"
                    w.breaker_trips += 1
                    w.window_ok = w.window_failed = 0
                    transition = ("closed", "half_open", w.breaker_trips)
                    gauge_set(
                        "tpuml_worker_breaker_state", 1.0, wid=worker_id
                    )
                    logger.warning(
                        "Worker %s breaker tripped -> half-open (probe tasks "
                        "only; trip %d/%d)",
                        worker_id, w.breaker_trips, cfg.breaker_max_trips,
                    )
                    evict = w.breaker_trips >= cfg.breaker_max_trips
        if transition is not None:
            from_state, to_state, trips = transition
            record_event(
                "breaker.transition", worker_id=worker_id,
                **{"from": from_state, "to": to_state, "trips": trips,
                   "max_trips": cfg.breaker_max_trips,
                   "evicting": bool(evict)},
            )
        if evict:
            self.evict_worker(worker_id)

    def release_task(self, worker_id: str, subtask_id: Optional[str]) -> bool:
        """Clear a worker's bookkeeping for a subtask whose attempt ended
        WITHOUT a metrics message (failed batches emit results only): queue
        entry, load/memory reservation, lease, and placement stamp. No
        speed-factor update — a failure carries no timing signal."""
        if subtask_id is None:
            return False
        with self._lock:
            w = self.workers.get(worker_id)
            if w is None or subtask_id not in w.task_est:
                return False
            est = w.task_est.pop(subtask_id, 0.0)
            mem = w.task_mem.pop(subtask_id, 0.0)
            w.task_lease.pop(subtask_id, None)
            w.task_placed_at.pop(subtask_id, None)
            w.load_seconds = max(0.0, w.load_seconds - est)
            w.mem_load_mb = max(0.0, w.mem_load_mb - mem)
            w.tasks_queue = [
                t for t in w.tasks_queue if t.get("subtask_id") != subtask_id
            ]
        return True

    def evict_worker(self, worker_id: str, reason: str = "circuit breaker") -> List[Dict[str, Any]]:
        """Remove a worker the breaker gave up on; requeue its queued tasks
        onto survivors and notify the runtime via ``on_evict`` so transport
        state (in-process worker threads / remote long-poll subscriptions)
        is torn down too."""
        with self._lock:
            state = self.workers.pop(worker_id, None)
            gauge_set("tpuml_workers_alive", len(self.workers))
        if state is None:
            return []
        logger.warning(
            "Worker %s evicted (%s); requeueing %d tasks",
            worker_id, reason, len(state.tasks_queue),
        )
        record_event(
            "worker.evict", worker_id=worker_id, reason=reason,
            n_requeued=len(state.tasks_queue),
            breaker_trips=state.breaker_trips,
        )
        self._drop_worker_gauges(worker_id)
        self._mesh_changed("evict", worker_id)
        hook = self.on_evict
        if hook is not None:
            try:
                hook(worker_id)
            except Exception:  # noqa: BLE001 — teardown must not block requeue
                logger.exception("on_evict hook failed for %s", worker_id)
        requeued = self._requeue(state.tasks_queue, from_worker=worker_id)
        self.refresh_health_metrics()
        return requeued

    def _straggler_ids_locked(self) -> set:
        """Workers whose batch EWMA exceeds ``straggler_factor`` x the
        median EWMA of their PEERS (own value excluded, so a two-worker
        pool can still flag its slow half). Requires
        ``straggler_min_batches`` reported outcomes — one slow cold batch
        must not brand a fresh worker. Caller holds the lock."""
        cfg = self.cfg
        measured = [
            (wid, w.ewma_batch_s)
            for wid, w in self.workers.items()
            if w.ewma_batch_s is not None
            and w.n_batches >= cfg.straggler_min_batches
        ]
        if len(measured) < 2:
            return set()
        flagged = set()
        for wid, ewma in measured:
            others = sorted(v for o, v in measured if o != wid)
            mid = len(others) // 2
            median = (
                others[mid]
                if len(others) % 2
                else 0.5 * (others[mid - 1] + others[mid])
            )
            if median > 0 and ewma > cfg.straggler_factor * median:
                flagged.add(wid)
        return flagged

    def _health_snapshot_locked(self) -> Dict[str, Dict[str, Any]]:
        now = time.time()
        stragglers = self._straggler_ids_locked()
        return {
            wid: {
                "ewma_batch_s": w.ewma_batch_s,
                "heartbeat_age_s": round(now - w.last_heartbeat, 3),
                "completed": w.n_completed,
                "failed": w.n_failed,
                "failure_ratio": w.failure_ratio(),
                "queue_depth": len(w.tasks_queue),
                "load_seconds": w.load_seconds,
                "speed_factor": w.speed_factor,
                "straggler": wid in stragglers,
                "breaker_state": w.breaker_state,
                "breaker_trips": w.breaker_trips,
                "n_devices": w.n_devices,
            }
            for wid, w in self.workers.items()
        }

    def health_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-worker health view: EWMA batch latency, heartbeat age,
        outcome counts/failure ratio, queue depth, straggler flag — the
        ``GET /healthz`` body and the tpuml_worker_* gauge source."""
        with self._lock:
            return self._health_snapshot_locked()

    def refresh_health_metrics(self) -> Dict[str, Dict[str, Any]]:
        """Write the health snapshot into the ``tpuml_worker_*{wid=...}``
        gauges and log straggler transitions. Called on metrics feedback,
        at /metrics/prom scrape, and by the sweep; returns the snapshot so
        callers (healthz) reuse one read. Snapshot AND gauge writes happen
        under one lock hold: writing from a stale snapshot could resurrect
        a concurrently-removed worker's cells after _drop_worker_gauges
        already cleaned them — permanently, since refresh only writes
        registered workers."""
        with self._lock:
            snap = self._health_snapshot_locked()
            for wid, h in snap.items():
                if h["ewma_batch_s"] is not None:
                    gauge_set(
                        "tpuml_worker_ewma_batch_seconds", h["ewma_batch_s"],
                        wid=wid,
                    )
                gauge_set(
                    "tpuml_worker_heartbeat_age_seconds", h["heartbeat_age_s"],
                    wid=wid,
                )
                gauge_set(
                    "tpuml_worker_failure_ratio", h["failure_ratio"], wid=wid
                )
                gauge_set("tpuml_worker_queue_depth", h["queue_depth"], wid=wid)
                gauge_set(
                    "tpuml_worker_straggler",
                    1.0 if h["straggler"] else 0.0,
                    wid=wid,
                )
                gauge_set(
                    "tpuml_worker_breaker_state",
                    1.0 if h["breaker_state"] == "half_open" else 0.0,
                    wid=wid,
                )
            current = {wid for wid, h in snap.items() if h["straggler"]}
            newly_flagged = sorted(current - self._flagged)
            recovered = sorted(self._flagged - current)
            self._flagged = current
        for wid in newly_flagged:
            logger.warning(
                "Worker %s flagged as straggler (batch EWMA %.3fs vs peers); "
                "placement now carries a +%.0fs advisory penalty",
                wid, snap[wid]["ewma_batch_s"], self.cfg.straggler_penalty_s,
            )
        for wid in recovered:
            logger.info("Worker %s no longer a straggler", wid)
        return snap

    def _drop_worker_gauges(self, worker_id: str) -> None:
        """A dead/unsubscribed worker must stop being exposed: remove its
        labeled cells from every per-worker gauge family."""
        from ..obs import REGISTRY

        for name in (
            "tpuml_worker_ewma_batch_seconds",
            "tpuml_worker_heartbeat_age_seconds",
            "tpuml_worker_failure_ratio",
            "tpuml_worker_queue_depth",
            "tpuml_worker_straggler",
            "tpuml_worker_breaker_state",
        ):
            g = REGISTRY.get(name)
            if g is not None and hasattr(g, "remove"):
                g.remove(wid=worker_id)
        self._flagged.discard(worker_id)

    # ---------------- placement ----------------

    def place(self, task: Dict[str, Any]) -> Optional[str]:
        """Choose a worker for a task, update its load, and (when a bus is
        wired) publish to the train topic keyed by worker id. Returns the
        worker id, or None if no workers exist. The decision latency feeds
        the ``tpuml_scheduler_placement_seconds`` histogram and, when the
        task carries a trace id, a ``schedule.place`` span."""
        t_place = time.perf_counter()
        est = self.predictor.predict(task)
        mem_mb = float(task.get("mem_estimate_mb", 1.0))
        # flight-recorder explainability: the full decision — per-candidate
        # scores, exclusions, penalties, the lease — is captured only when
        # obs is on (the breakdown dicts are not free, the decision is)
        explain = obs_enabled()
        breakdown: Optional[Dict[str, Any]] = None
        with self._lock:
            if not self.workers:
                return None
            mem_fallback = False
            eligible = [
                w
                for w in self.workers.values()
                if w.mem_load_mb + mem_mb <= w.mem_capacity_mb
            ]
            if not eligible:
                logger.warning(
                    "No worker fits task %s (%.0f MB); falling back to all",
                    task.get("subtask_id"),
                    mem_mb,
                )
                eligible = list(self.workers.values())
                mem_fallback = True
            # excluded-worker memory (retries must not land on the worker
            # that just failed/hung the task) — a preference, not a gate:
            # when only excluded workers remain, liveness wins
            excluded = set(task.get("excluded_workers") or ())
            excluded_overridden = False
            if excluded:
                non_excluded = [
                    w for w in eligible if w.worker_id not in excluded
                ]
                if non_excluded:
                    eligible = non_excluded
                else:
                    excluded_overridden = True
                    logger.warning(
                        "Every eligible worker is excluded for %s; "
                        "falling back to the excluded pool",
                        task.get("subtask_id"),
                    )
            # circuit breaker: a half-open worker takes PROBE tasks only —
            # at most one in flight (empty queue). If no closed or
            # probe-ready worker exists, fall back rather than stall.
            breaker_ok = [
                w for w in eligible
                if w.breaker_state != "half_open" or not w.tasks_queue
            ]
            if breaker_ok:
                eligible = breaker_ok
            # straggler consumption is ADVISORY: a flat score penalty on
            # flagged workers only — eligibility, fallback, and the score
            # formula for healthy workers are untouched. Reads the flag
            # set maintained by refresh_health_metrics (feedback/scrape/
            # sweep) — recomputing peer medians on every placement would
            # put O(W^2 log W) work on the hot path this module times.
            stragglers = self._flagged
            penalty = self.cfg.straggler_penalty_s

            def _score(w: WorkerState) -> float:
                # predictor-aware mesh packing: the estimate is priced per
                # mesh slice (est / n_devices) so a wide slice absorbs the
                # expensive wide-W trials while cheap trials keep landing
                # on narrow workers instead of serializing behind them
                return (
                    w.effective_finish_time()
                    + w.slice_est(est) / max(w.speed_factor, 1e-3)
                    + (penalty if w.worker_id in stragglers else 0.0)
                )

            best = min(eligible, key=_score)
            stid = task.get("subtask_id")
            if explain:
                # snapshot the score terms BEFORE the books absorb this
                # task — the breakdown must show the inputs of the
                # decision, not its side effects
                ranked = sorted(eligible, key=_score)[:8]
                breakdown = {
                    "est_runtime_s": est,
                    "mem_estimate_mb": mem_mb,
                    "n_workers": len(self.workers),
                    "n_eligible": len(eligible),
                    "mem_fallback": mem_fallback,
                    "excluded": sorted(excluded),
                    "excluded_overridden": excluded_overridden,
                    "penalized": sorted(
                        w.worker_id for w in eligible
                        if w.worker_id in stragglers
                    ),
                    "chosen_score": _score(best),
                    # the packing decision's mesh context (docs/
                    # ARCHITECTURE.md "Elastic trial fabric"): the chosen
                    # worker's slice shape and the fleet generation the
                    # placement happened under
                    "mesh_slice": {
                        "n_devices": best.n_devices,
                        "mesh_shape": best.mesh_shape,
                        "generation": self.mesh_generation,
                    },
                    "candidates": [
                        {
                            "worker_id": w.worker_id,
                            "score": _score(w),
                            "effective_finish_time_s":
                                w.effective_finish_time(),
                            "est_over_speed_s":
                                w.slice_est(est) / max(w.speed_factor, 1e-3),
                            "speed_factor": w.speed_factor,
                            "n_devices": w.n_devices,
                            "load_seconds": w.load_seconds,
                            "mem_load_mb": w.mem_load_mb,
                            "queue_depth": len(w.tasks_queue),
                            "penalty_s": penalty
                            if w.worker_id in stragglers else 0.0,
                            "breaker_state": w.breaker_state,
                        }
                        for w in ranked
                    ],
                }
            # books absorb the SLICE-priced estimate: the same figure
            # on_metrics pops back out and the lease/calibration paths
            # consume — the predictor is measured against the estimate
            # that actually drove the decision
            est = best.slice_est(est)
            best.load_seconds += est
            best.mem_load_mb += mem_mb
            best.tasks_queue.append(task)
            best.task_est[stid] = est
            best.task_mem[stid] = mem_mb
            # stamp the fleet generation the placement happened under —
            # a reshard (join/death/evict) bumps it, and re-placements of
            # reclaimed work carry the new generation with their fresh
            # attempt id
            task["mesh_generation"] = self.mesh_generation
            now = time.time()
            best.task_placed_at[stid] = now
            lease_deadline = None
            if self.cfg.lease_factor > 0:
                # lease covers the PREDICTED completion time on this worker
                # — queue wait included (effective_finish_time already
                # absorbed this task's estimate above), speed-adjusted —
                # so deep queues don't expire healthy leases; the floor
                # absorbs cold-start noise
                lease_deadline = now + max(
                    self.cfg.lease_floor_s,
                    self.cfg.lease_factor * best.effective_finish_time(),
                )
                best.task_lease[stid] = lease_deadline
            wid = best.worker_id
        elapsed = time.perf_counter() - t_place
        observe("tpuml_scheduler_placement_seconds", elapsed)
        counter_inc("tpuml_subtasks_dispatched_total")
        attempt = int(task.get("attempt") or 0)
        if breakdown is not None:
            record_event(
                "placement",
                job_id=task.get("job_id"),
                subtask_id=stid,
                worker_id=wid,
                attempt=attempt,
                **breakdown,
            )
            if lease_deadline is not None:
                record_event(
                    "lease.grant",
                    job_id=task.get("job_id"),
                    subtask_id=stid,
                    worker_id=wid,
                    attempt=attempt,
                    deadline_ts=lease_deadline,
                    lease_s=lease_deadline - now,
                    lease_factor=self.cfg.lease_factor,
                    lease_floor_s=self.cfg.lease_floor_s,
                )
        tid = task.get("trace_id")
        if tid:
            # the decision already ran: back-date the span over it
            with span("schedule.place", trace_id=tid, parent_id=None,
                      subtask_id=stid, worker=wid, est_runtime_s=est,
                      attempt=attempt) as sp:
                sp.start = time.time() - elapsed
        hook = self.on_place
        if hook is not None:
            try:
                hook(task, wid, lease_deadline)
            except Exception:  # noqa: BLE001 — journaling must not kill dispatch
                logger.exception(
                    "Placement journal hook failed for %s", stid
                )
        if self.bus is not None:
            self.bus.publish(TOPIC_TRAIN, task, key=wid)
        return wid

    # ---------------- feedback ----------------

    def on_metrics(self, msg: Dict[str, Any]) -> None:
        """Consume a worker metrics message (schema: worker.py:233-243)."""
        wid = msg.get("worker_id")
        stid = msg.get("subtask_id")
        started = msg.get("started_at")
        finished = msg.get("finished_at")
        actual = None
        if started is not None and finished is not None:
            actual = max(float(finished) - float(started), 1e-3)
        # cooperative-cancel guard (docs/SEARCH.md): a cancelled/pruned
        # attempt's message releases the worker's books below but must
        # NEVER feed the predictor, the calibration windows, or the
        # speed/health EWMAs — a trial stopped at rung 1 would log a
        # wildly small "actual" against a full-budget estimate and poison
        # the ratio every lease is derived from
        if msg.get("cancelled"):
            actual = None
        with self._lock:
            w = self.workers.get(wid)
            if w is None:
                return
            n_dev = max(int(w.n_devices or 1), 1)
            est = w.task_est.pop(stid, 0.0)
            mem = w.task_mem.pop(stid, 0.0)
            w.task_lease.pop(stid, None)
            w.task_placed_at.pop(stid, None)
            w.load_seconds = max(0.0, w.load_seconds - est)
            w.mem_load_mb = max(0.0, w.mem_load_mb - mem)
            w.tasks_queue = [t for t in w.tasks_queue if t.get("subtask_id") != stid]
            if actual is not None and est > 0:
                ratio = est / actual
                w.speed_factor = min(
                    self.cfg.speed_factor_max,
                    max(
                        self.cfg.speed_factor_min,
                        (1 - self.cfg.speed_ema_alpha) * w.speed_factor
                        + self.cfg.speed_ema_alpha * ratio,
                    ),
                )
            # every subtask of a batch reports the SAME batch wall time, so
            # the health EWMA absorbs it once per batch — only the primary
            # message updates (messages without the marker, e.g. synthetic
            # feedback in tests, count as primary)
            batch_once = msg.get("batch_primary") is not False
            if actual is not None and batch_once:
                a = self.cfg.health_ema_alpha
                w.ewma_batch_s = (
                    actual
                    if w.ewma_batch_s is None
                    else (1 - a) * w.ewma_batch_s + a * actual
                )
                w.n_batches += 1
        if actual is not None:
            # the predictor learns DEVICE-NORMALIZED walls: a wall measured
            # on an N-device slice is already slice-shortened, and place()
            # divides the estimate by the candidate's slice width — feeding
            # the raw wall would divide by n_devices twice (estimates and
            # leases shrinking toward T/N^2 on wide fleets). Calibration
            # and the speed/health EWMAs below stay per-worker raw: they
            # measure the AS-USED sliced estimate against this worker.
            self.predictor.observe(msg, actual * n_dev)
            if est > 0:
                # calibration telemetry: est is the exact estimate the
                # placement consumed (algo multiplier included) and the
                # lease was derived from — measure the predictor AS USED.
                # getattr: engine-level tests run stub predictors without
                # the calibration surface.
                rec = getattr(self.predictor, "record_calibration", None)
                if rec is not None:
                    # executor metrics messages carry the family as "algo"
                    # (reference schema); synthetic test feedback uses
                    # "model_type"
                    rec(msg.get("algo") or msg.get("model_type"), est, actual)
            if batch_once:
                self.refresh_health_metrics()

    # ---------------- failure detection ----------------

    def start_monitor(self) -> None:
        if self._monitor_thread is not None:
            return
        self._stop.clear()
        self._monitor_thread = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor_thread.start()

    def stop_monitor(self) -> None:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=2)
            self._monitor_thread = None

    def sweep(self) -> List[str]:
        """One failure-detection pass: dead-worker detection (heartbeat
        silence), lease reclaim from LIVE but hung workers, and the
        speculative-execution check. Returns ids of workers declared
        dead."""
        now = time.time()
        dead: List[WorkerState] = []
        reclaimed: List[tuple] = []  # (worker_id, task)
        with self._lock:
            for wid, w in list(self.workers.items()):
                if now - w.last_heartbeat > self.cfg.dead_after_s:
                    dead.append(self.workers.pop(wid))
                    continue
                # lease reclaim: an expired lease on a live worker means the
                # worker is hung (or silently dropped the result) — pull the
                # task back and release the books; re-dispatch happens below
                for task in list(w.tasks_queue):
                    stid = task.get("subtask_id")
                    deadline = w.task_lease.get(stid)
                    if deadline is None or now <= deadline:
                        continue
                    w.tasks_queue = [
                        t for t in w.tasks_queue
                        if t.get("subtask_id") != stid
                    ]
                    est = w.task_est.pop(stid, 0.0)
                    mem = w.task_mem.pop(stid, 0.0)
                    w.task_lease.pop(stid, None)
                    w.task_placed_at.pop(stid, None)
                    w.load_seconds = max(0.0, w.load_seconds - est)
                    w.mem_load_mb = max(0.0, w.mem_load_mb - mem)
                    reclaimed.append((wid, task, now - deadline))
            if dead:
                gauge_set("tpuml_workers_alive", len(self.workers))
        for wid, task, overdue_s in reclaimed:
            stid = task.get("subtask_id")
            if stid and self.ledger.is_done(stid):
                continue  # a duplicate attempt already delivered a result
            # a reclaim is a failed execution budget-wise: a subtask that
            # hangs EVERY worker must exhaust its budget and quarantine,
            # not cycle through reclaims until the job's hard deadline.
            # When this reclaim would be the final allowed execution, a
            # synthetic failed result goes to the coordinator (whose
            # ingest counts it and quarantines) instead of a re-dispatch.
            entry = self.ledger.get(stid)
            failures_so_far = entry.failures if entry is not None else 0
            record_event(
                "lease.reclaim",
                job_id=task.get("job_id"), subtask_id=stid, worker_id=wid,
                attempt=int(task.get("attempt") or 0),
                overdue_s=round(overdue_s, 3),
                failures_so_far=failures_so_far,
                budget_exhausted=(
                    failures_so_far + 1 >= self.cfg.retry_max_attempts
                ),
            )
            if failures_so_far + 1 >= self.cfg.retry_max_attempts:
                logger.error(
                    "Lease expired for %s on %s and its retry budget is "
                    "exhausted (%d prior failures); failing it for "
                    "quarantine", stid, wid, failures_so_far,
                )
                if self.bus is not None:
                    self.bus.publish(TOPIC_RESULT, {
                        "subtask_id": stid,
                        "job_id": task.get("job_id"),
                        "model_type": task.get("model_type"),
                        "parameters": task.get("parameters"),
                        "status": "failed",
                        "error": f"lease expired on worker {wid} "
                                 f"(hung or silent) with no budget left",
                        "error_kind": "lease_expired",
                        "attempt": int(task.get("attempt") or 0),
                        "worker_id": wid,
                    }, key=stid)
                continue
            self.ledger.record_failure(stid, wid)
            # COPY before stamping: the hung executor still holds this
            # dict (the bus delivers by reference) — mutating it in place
            # would let the zombie's eventual result carry the NEW attempt
            # id and defeat the attempt-stamp dedup
            task = dict(task)
            logger.warning(
                "Lease expired for %s on live worker %s; reclaiming and "
                "requeueing (attempt %d)",
                stid, wid, int(task.get("attempt") or 0) + 1,
            )
            self.ledger.next_attempt(task, exclude_worker=wid, reason="lease")
            counter_inc("tpuml_subtasks_retried_total", reason="lease")
            self._replace(task)
        for w in dead:
            logger.warning(
                "Worker %s dead (no heartbeat for >%ss); requeueing %d tasks",
                w.worker_id,
                self.cfg.dead_after_s,
                len(w.tasks_queue),
            )
            record_event(
                "worker.dead", worker_id=w.worker_id,
                heartbeat_silence_s=round(now - w.last_heartbeat, 3),
                n_requeued=len(w.tasks_queue),
            )
            self._drop_worker_gauges(w.worker_id)
            self._mesh_changed("death", w.worker_id)
            self._requeue(w.tasks_queue, from_worker=w.worker_id)
        self._speculate()
        if dead or reclaimed:
            self.refresh_health_metrics()
        # one time-series sample per sweep: the embedded metrics history
        # rides the cadence every other periodic decision already runs on
        # (obs/timeseries.py; throttled, no-op when disabled). The derived
        # route-p99 gauge refreshes first so the sample catches it even on
        # coordinators nothing ever scrapes (dashboard-only deployments).
        refresh_route_p99()
        timeseries_sample()
        # fleet-health tick rides the same cadence, AFTER the sample so
        # the alert rules see this sweep's datapoints
        hook = self.on_sweep_end
        if hook is not None:
            try:
                hook()
            except Exception:  # noqa: BLE001 — health derivation must not break the sweep
                logger.exception("on_sweep_end hook failed")
        return [w.worker_id for w in dead]

    def _speculate(self) -> List[Dict[str, Any]]:
        """Backup-task launch (Dean & Ghemawat OSDI'04; "The Tail at
        Scale"): an in-flight subtask whose age exceeds
        ``straggler_factor`` x the peer-median batch EWMA (floored at
        ``speculative_min_inflight_s``) gets ONE duplicate on an idle,
        breaker-closed worker, excluded from its owner. At most one launch
        per straggling worker per sweep; the coordinator's result ingest
        dedups by attempt id — first terminal result wins."""
        cfg = self.cfg
        if not cfg.speculative_enabled:
            return []
        shed = self.shed_check
        if shed is not None:
            try:
                overloaded = bool(shed())
            except Exception:  # noqa: BLE001 — the probe must not kill the sweep
                overloaded = False
            if overloaded:
                # graceful degradation (docs/ROBUSTNESS.md "Admission
                # control"): under overload the OPTIONAL duplicate work
                # goes first — capacity serves admitted jobs, not hedges
                counter_inc("tpuml_overload_shed_total", kind="speculative")
                return []
        now = time.time()
        launches: List[tuple] = []  # (owner_wid, task copy)
        with self._lock:
            measured = [
                (wid, w.ewma_batch_s)
                for wid, w in self.workers.items()
                if w.ewma_batch_s is not None
                and w.n_batches >= cfg.straggler_min_batches
            ]
            if len(measured) < 2:
                return []
            idle = sum(
                1 for w in self.workers.values()
                if not w.tasks_queue and w.breaker_state == "closed"
            )
            if idle == 0:
                return []
            for wid, w in self.workers.items():
                if len(launches) >= idle:
                    break
                if not w.tasks_queue:
                    continue
                others = sorted(v for o, v in measured if o != wid)
                if not others:
                    continue
                mid = len(others) // 2
                median = (
                    others[mid]
                    if len(others) % 2
                    else 0.5 * (others[mid - 1] + others[mid])
                )
                threshold = max(
                    cfg.speculative_min_inflight_s,
                    cfg.straggler_factor * median,
                )
                for task in w.tasks_queue:
                    stid = task.get("subtask_id")
                    if not stid:
                        continue
                    placed = w.task_placed_at.get(stid)
                    if placed is None or now - placed <= threshold:
                        continue
                    if self.ledger.was_speculated(stid) or self.ledger.is_done(stid):
                        continue
                    launches.append((wid, dict(task), now - placed))
                    break  # one duplicate per straggling worker per sweep
        launched = []
        for owner, task, age in launches:
            self.ledger.next_attempt(
                task, exclude_worker=owner, reason="speculative",
                speculative=True,
            )
            counter_inc("tpuml_speculative_launched_total")
            logger.warning(
                "Speculating duplicate of %s (in-flight %.1fs on %s, "
                "attempt %d)",
                task.get("subtask_id"), age, owner, task["attempt"],
            )
            record_event(
                "speculate.launch",
                job_id=task.get("job_id"),
                subtask_id=task.get("subtask_id"),
                worker_id=owner, attempt=task["attempt"],
                in_flight_s=round(age, 3),
            )
            tid = task.get("trace_id")
            if tid:
                with span("schedule.speculate", trace_id=tid, parent_id=None,
                          subtask_id=task.get("subtask_id"), owner=owner,
                          attempt=task["attempt"]):
                    pass
            self._replace(task)
            launched.append(task)
        return launched

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.cfg.sweep_interval_s):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001
                logger.exception("Heartbeat sweep failed")

    def _requeue(
        self, tasks: List[Dict[str, Any]], from_worker: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        """Re-place tasks off a dead/unsubscribed/evicted worker. Each gets
        a fresh attempt id (attempt-stamp dedup stays sound even if a
        'dead' worker turns out to be a zombie and reports late) with the
        departed worker remembered as excluded; tasks whose ledger entry is
        already terminal are dropped, not re-run."""
        requeued = []
        for task in tasks:
            stid = task.get("subtask_id")
            if stid and self.ledger.is_done(stid):
                continue  # a duplicate attempt already delivered a result
            if stid:
                # copy before stamping: a zombie worker (swept as dead but
                # actually wedged) still holds this dict — in-place attempt
                # mutation would defeat the attempt-stamp dedup
                task = dict(task)
                self.ledger.next_attempt(
                    task, exclude_worker=from_worker, reason="requeue"
                )
            counter_inc("tpuml_subtasks_requeued_total")
            if self._replace(task) is not None:
                requeued.append(task)
        return requeued

    def _replace(self, task: Dict[str, Any]) -> Optional[str]:
        """Place a reclaimed/requeued/speculative task, or drop it back to
        the tasks topic when no worker survives."""
        wid = self.place(task)
        if wid is None:
            logger.error(
                "No surviving worker for %s; task dropped back to tasks topic",
                task.get("subtask_id"),
            )
            if self.bus is not None:
                self.bus.publish(TOPIC_TASKS, task)
        return wid
