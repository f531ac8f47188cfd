"""Cluster runtime: scheduler-mediated dispatch to a pool of executors.

Port of the JAX package's ``runtime/cluster.py``: in-process executors on
the card (or the CPU), remote agents over REST (register, long-poll pull,
result and metrics push), the dead-worker sweep and requeue, device-loss
correlation and cooperative cancels. ``shard_id`` makes the runtime one
shard of a sharded control plane: the engine mints ``s<k>-worker-<n>``
ids (runtime/sharding.worker_prefix), so front ends route worker-plane
requests by the stamp. Every worker reports its mesh slice at
registration (``parallel/mesh.mesh_info``: a trial mesh of N ranks is N
devices, a plain executor one), and placement prices a batch per slice.
The remote metrics ingest (``push_metrics``) counts a remote
batch's phase timers, device-seconds and FLOPs once, on its primary
message, unless the batch ran in this process.

This is the process topology of the reference system — master -> Kafka
``tasks`` -> scheduler -> Kafka ``train`` (keyed by worker) -> workers ->
``result``/``metrics`` back (SURVEY.md §1) — collapsed onto the in-process
TopicBus with the same message flow and the same failure semantics:

  coordinator.submit -> bus:"tasks" -> PlacementEngine.place ->
  bus:"train"(key=worker_id) -> ExecutorWorker loop -> run on the device ->
  bus:"result" (coordinator collects), bus:"metrics" (engine feedback)

Executors heartbeat the engine; killing one (crash simulation) triggers the
dead-worker sweep and requeue onto survivors, mirroring the reference's
elastic recovery (scheduler_service.py:205-247). A worker drains its queue
and hands the whole batch to the trial engine: scheduling stays dynamic at
worker granularity while a batch runs as whole trial buckets on the card.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

from ..obs import (
    counter_inc,
    gauge_set,
    observe,
    process_token,
    record_batch_device_seconds,
    record_event,
)
from ..utils.config import get_config
from ..utils.logging import get_logger
from ..utils.torch_setup import DeviceLike, resolve_device
from .executor import DeviceLostError, LocalExecutor
from .faults import AttemptLedger
from .queue import TopicBus
from .scheduler import TOPIC_TASKS, TOPIC_TRAIN, PlacementEngine
from .store import SUBTASK_TERMINAL_STATUSES

logger = get_logger("tpuml.cluster")

TOPIC_RESULT = "result"
TOPIC_METRICS = "metrics"


class ExecutorWorker:
    """Reference-worker lifecycle (worker.py:90-286) around an executor:
    subscribe -> heartbeat thread -> keyed consume loop -> emit result+metrics."""

    def __init__(self, cluster: "ClusterRuntime", executor: LocalExecutor, worker_id: str):
        self.cluster = cluster
        self.executor = executor
        self.worker_id = worker_id
        self._stop = threading.Event()
        # priority=True: the worker drains its keyed queue highest QoS
        # lane first (docs/ARCHITECTURE.md "QoS priority lanes")
        self._sub = cluster.bus.subscribe(
            TOPIC_TRAIN, key_filter=lambda k: k == worker_id, priority=True
        )
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        for target in (self._run_loop, self._heartbeat_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, graceful: bool = True) -> None:
        self._stop.set()
        self._sub.close()
        if graceful:
            self.cluster.engine.unsubscribe(self.worker_id)

    def kill(self) -> None:
        """Crash simulation: loops stop, no unsubscribe — the engine only
        finds out via missed heartbeats."""
        self._stop.set()
        self._sub.close()

    # ---------------- loops ----------------

    def _heartbeat_loop(self) -> None:
        interval = get_config().scheduler.heartbeat_interval_s
        while not self._stop.wait(interval):
            self.cluster.engine.heartbeat(self.worker_id)

    def _run_loop(self) -> None:
        max_batch = self.executor.max_trials_per_batch
        while not self._stop.is_set():
            try:
                _, first = self._sub.get(timeout=0.2)
            except _queue.Empty:
                continue
            batch = [first]
            while len(batch) < max_batch:
                try:
                    batch.append(self._sub.get_nowait()[1])
                except _queue.Empty:
                    break
            if self._stop.is_set():
                # crash between dequeue and execution: tasks are lost here and
                # recovered by the dead-worker requeue (at-least-once)
                return
            def on_result(stid, status, result):
                # in-process workers bypass push_result, so the engine's
                # per-worker failure accounting hooks here. worker_id rides
                # the result so the coordinator's retry path can exclude
                # the failing worker; a failed attempt emits no metrics
                # message, so the engine's books are released here instead.
                result = {**(result or {}), "worker_id": self.worker_id}
                failed = status == "failed"
                self.cluster.engine.record_outcome(self.worker_id, not failed)
                if failed or status == "pruned":
                    # neither emits a timed metrics message: release the
                    # engine's books here (pruned = cooperative cancel,
                    # docs/SEARCH.md — a non-failure terminal)
                    self.cluster.engine.release_task(self.worker_id, stid)
                self.cluster.bus.publish(TOPIC_RESULT, result, key=stid)

            try:
                self.executor.run_subtasks(
                    batch,
                    on_result=on_result,
                    on_metrics=lambda msg: self.cluster.bus.publish(
                        TOPIC_METRICS, {**msg, "worker_id": self.worker_id}, key=msg.get("subtask_id")
                    ),
                )
            except DeviceLostError:
                # containment: this worker's backend is gone for good — leave
                # the pool like a crashed worker (no unsubscribe), so the
                # dead-worker sweep requeues its queued tasks onto survivors.
                # The engine's queue still holds this batch (metrics feedback
                # never fired), so nothing is lost. If this was the last
                # executor, the job surfaces the stall via the coordinator's
                # progress-aware timeout.
                logger.exception(
                    "Worker %s lost its device backend; leaving the pool",
                    self.worker_id,
                )
                # poison correlation first: a subtask on its Nth killed
                # backend must be quarantined, not requeued to kill N+1
                self.cluster.note_device_loss(self.worker_id, batch)
                self.cluster.kill_executor(self.worker_id)
                return
            except Exception:  # noqa: BLE001
                logger.exception("Worker %s batch execution failed", self.worker_id)


class ClusterRuntime:
    def __init__(self, *, cache=None, predictor=None, shard_id=None):
        self.bus = TopicBus()
        #: shared attempt/exclusion/poison accounting: the engine bumps it
        #: on lease reclaims/requeues/speculation, the coordinator on
        #: failure retries; one ledger keeps attempt ids monotonic
        self.ledger = AttemptLedger()
        #: shard identity: stamps minted worker ids; None = unsharded
        self.shard_id = shard_id
        prefix = ""
        if shard_id is not None:
            from .sharding import worker_prefix

            prefix = worker_prefix(int(shard_id))
        self.engine = PlacementEngine(bus=self.bus, predictor=predictor, ledger=self.ledger,
                                      worker_prefix=prefix)
        self.engine.on_evict = self._on_worker_evicted
        self.cache = cache
        self.workers: Dict[str, ExecutorWorker] = {}
        self._remote_subs: Dict[str, Any] = {}
        #: cooperative-cancel registry: subtask_id -> {subtask_id, attempt,
        #: job_id}. Served on every /next_tasks long-poll (the agents'
        #: cancel list) and pushed straight into in-process workers'
        #: executors; entries clear when the subtask's terminal result
        #: lands or its job's loop ends.
        self._cancel_lock = threading.Lock()
        self._cancels: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        for target in (self._ingress_loop, self._metrics_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        self.engine.start_monitor()

    # ---------------- executor pool ----------------

    def add_executor(self, device: DeviceLike = None, mem_capacity_mb: Optional[float] = None,
                     executor: Optional[LocalExecutor] = None, mesh=None) -> str:
        """Subscribe an in-process worker. ``device`` defaults to the CUDA
        card (raises without one); ``device="cpu"`` runs it on the host.
        ``mesh`` (or the given executor's) is reported as its slice."""
        from ..parallel.mesh import mesh_info

        if mesh is None and executor is not None:
            mesh = executor.mesh
        n_devices, mesh_shape = mesh_info(mesh)
        wid = self.engine.subscribe(mem_capacity_mb=mem_capacity_mb, n_devices=n_devices,
                                    mesh_shape=mesh_shape)
        if executor is None:
            executor = LocalExecutor(resolve_device(device), cache=self.cache, mesh=mesh)
        executor.executor_id = wid
        worker = ExecutorWorker(self, executor, wid)
        self.workers[wid] = worker
        worker.start()
        return wid

    def remove_executor(self, worker_id: str, graceful: bool = True) -> None:
        worker = self.workers.pop(worker_id, None)
        if worker is not None:
            worker.stop(graceful=graceful)

    def kill_executor(self, worker_id: str) -> None:
        """Fault injection: crash a worker without unsubscribe."""
        worker = self.workers.pop(worker_id, None)
        if worker is not None:
            worker.kill()

    def _on_worker_evicted(self, worker_id: str) -> None:
        """Breaker eviction teardown: stop the in-process worker threads
        and/or close the remote long-poll subscription — the engine already
        removed the WorkerState and requeues the tasks."""
        worker = self.workers.pop(worker_id, None)
        if worker is not None:
            worker.kill()
        sub = self._remote_subs.pop(worker_id, None)
        if sub is not None:
            sub.close()

    def note_device_loss(self, worker_id: str, tasks: List[Dict[str, Any]]) -> None:
        """Correlate a backend loss with the subtasks that rode the dying
        batch. A subtask that has now killed ``poison_kill_threshold``
        worker backends is poisoned: release it from the dying worker's
        queue (so the dead-worker sweep does NOT requeue it to kill a
        third) and publish a synthetic failed result the coordinator
        quarantines on ingest. Below the threshold, nothing happens here —
        the task stays queued for the normal sweep requeue."""
        threshold = get_config().scheduler.poison_kill_threshold
        for task in tasks:
            stid = task.get("subtask_id")
            if not stid:
                continue
            kills = self.ledger.note_device_loss(stid)
            if kills < threshold:
                continue
            logger.error(
                "Subtask %s killed %d worker backends; poisoning it instead "
                "of requeueing", stid, kills,
            )
            record_event(
                "poison", job_id=task.get("job_id"), subtask_id=stid,
                worker_id=worker_id,
                attempt=int(task.get("attempt") or 0),
                device_losses=kills, threshold=threshold,
            )
            self.engine.release_task(worker_id, stid)
            self.bus.publish(
                TOPIC_RESULT,
                {
                    "subtask_id": stid,
                    "job_id": task.get("job_id"),
                    "model_type": task.get("model_type"),
                    "parameters": task.get("parameters"),
                    "status": "failed",
                    "error": f"subtask killed {kills} worker backends "
                             "(device loss correlation)",
                    "error_kind": "device_lost",
                    "attempt": int(task.get("attempt") or 0),
                    "worker_id": worker_id,
                },
                key=stid,
            )

    # ---------------- cooperative cancel (docs/SEARCH.md) ----------------

    def cancel_subtask(
        self, subtask_id: str, attempt: int = 0,
        job_id: Optional[str] = None,
    ) -> None:
        """Mark a subtask's current attempt cancelled. Remote agents pick
        it up from their next poll's ``cancel`` list; in-process workers'
        executors are updated immediately. The executor stops the trial at
        the next batch boundary and posts a terminal ``pruned`` result; a
        dead/ignoring worker is covered by the lease reclaim + the
        ledger's ``is_done`` requeue drop."""
        entry = {
            "subtask_id": subtask_id,
            "attempt": int(attempt or 0),
            "job_id": job_id,
        }
        with self._cancel_lock:
            self._cancels[subtask_id] = entry
        counter_inc("tpuml_cancels_issued_total")
        for worker in list(self.workers.values()):
            worker.executor.cancel([entry])

    def cancel_list(self) -> List[Dict[str, Any]]:
        with self._cancel_lock:
            return list(self._cancels.values())

    def clear_cancels(self, subtask_ids) -> None:
        with self._cancel_lock:
            for stid in subtask_ids:
                self._cancels.pop(stid, None)

    # ---------------- remote agents (DCN control plane) ----------------
    # A remote WorkerAgent (runtime/agent.py) on another host registers here
    # over REST and long-polls its keyed train queue — the HTTP analog of the
    # reference worker's /subscribe + keyed Kafka consumption
    # (worker.py:90-112, 185-186).

    def register_remote(self, mem_capacity_mb: Optional[float] = None,
                        n_devices: Optional[int] = None,
                        mesh_shape: Optional[Dict[str, int]] = None) -> str:
        wid = self.engine.subscribe(mem_capacity_mb=mem_capacity_mb, n_devices=n_devices,
                                    mesh_shape=mesh_shape)
        self._remote_subs[wid] = self.bus.subscribe(
            TOPIC_TRAIN, key_filter=lambda k, w=wid: k == w, priority=True
        )
        return wid

    def unregister_remote(self, worker_id: str) -> None:
        sub = self._remote_subs.pop(worker_id, None)
        if sub is not None:
            sub.close()
        self.engine.unsubscribe(worker_id)

    def pull_tasks(self, worker_id: str, max_n: int = 64, timeout_s: float = 10.0) -> List[Dict[str, Any]]:
        """Long-poll the worker's train queue: blocks up to timeout for the
        first task, then drains without blocking."""
        sub = self._remote_subs.get(worker_id)
        if sub is None:
            raise KeyError(f"Unknown remote worker {worker_id}")
        counter_inc("tpuml_agent_polls_total")
        tasks: List[Dict[str, Any]] = []
        try:
            tasks.append(sub.get(timeout=timeout_s)[1])
        except _queue.Empty:
            return tasks
        while len(tasks) < max_n:
            try:
                tasks.append(sub.get_nowait()[1])
            except _queue.Empty:
                break
        if tasks:
            counter_inc("tpuml_agent_tasks_pulled_total", len(tasks))
        return tasks

    def push_result(self, worker_id: str, result: Dict[str, Any]) -> None:
        counter_inc("tpuml_agent_acks_total")
        result = dict(result or {})
        # wire-only dedup stamp (agent._post_result): popped so it never
        # reaches the job store / client-visible results
        src_pid = result.pop("obs_pid", None)
        ok = result.get("status") != "failed"
        result.setdefault("worker_id", worker_id)
        if worker_id not in self.engine.workers:
            # a worker this coordinator never registered — typically an
            # agent flushing its local result buffer across a coordinator
            # restart, still posting under the pre-crash worker id
            # (docs/ROBUSTNESS.md "Coordinator recovery"). The result IS
            # ingested (at-least-once; the job-side attempt dedup owns
            # duplicates) — only the per-worker books are unknown.
            counter_inc("tpuml_agent_orphan_results_total")
            record_event(
                "result.orphan", job_id=result.get("job_id"),
                subtask_id=result.get("subtask_id"), worker_id=worker_id,
                attempt=int(result.get("attempt") or 0),
            )
        self.engine.record_outcome(worker_id, ok)
        if result.get("status") in ("failed", "pruned", "diverged"):
            # failed attempts emit no metrics message, and a pruned (or
            # watchdog-diverged) attempt's release message may race the
            # result: release the engine's books (queue entry, load,
            # lease) here (idempotent — release_task no-ops once the
            # books are clear)
            self.engine.release_task(worker_id, result.get("subtask_id"))
        if result.get("status") in SUBTASK_TERMINAL_STATUSES:
            self.clear_cancels([result.get("subtask_id")])
        # count the outcome coordinator-side so /metrics/prom sees subtasks
        # executed in other processes — but not twice for an agent sharing
        # THIS process (its executor already counted into the shared
        # registry; same contract as push_metrics' obs_pid skip)
        if src_pid != process_token():
            counter_inc(
                "tpuml_subtasks_completed_total"
                if ok
                else "tpuml_subtasks_failed_total"
            )
        self.bus.publish(TOPIC_RESULT, result, key=result.get("subtask_id"))

    def push_metrics(self, worker_id: str, msg: Dict[str, Any]) -> None:
        # a remote batch's phase timers and cost figures -> this registry.
        # An agent's registry lives in its own process, so the batch totals
        # ride the metrics message: batch_primary marks one message a
        # batch, and obs_pid the process that already observed it (an
        # agent in THIS process is skipped, so nothing counts twice)
        if msg.get("batch_primary") and msg.get("obs_pid") != process_token():
            for field, metric in (
                ("batch_compile_s", "tpuml_executor_compile_seconds"),
                ("batch_stage_s", "tpuml_executor_stage_seconds"),
                ("batch_dispatch_s", "tpuml_executor_dispatch_seconds"),
                ("batch_fetch_s", "tpuml_executor_fetch_seconds"),
            ):
                v = msg.get(field)
                if isinstance(v, (int, float)):
                    observe(metric, float(v))
            phase = {f: msg.get(f) for f in ("batch_compile_s", "batch_stage_s",
                                             "batch_dispatch_s", "batch_fetch_s")}
            if all(isinstance(v, (int, float)) for v in phase.values()):
                record_batch_device_seconds(
                    phase["batch_compile_s"], phase["batch_stage_s"],
                    phase["batch_dispatch_s"], phase["batch_fetch_s"])
            algo = str(msg.get("algo") or "unknown")
            flops = msg.get("batch_model_flops")
            if flops is None:
                flops = msg.get("batch_xla_flops")
            if isinstance(flops, (int, float)):
                counter_inc("tpuml_executor_flops_total", float(flops), model=algo)
            nbytes = msg.get("batch_bytes_accessed")
            if isinstance(nbytes, (int, float)):
                counter_inc("tpuml_executor_bytes_total", float(nbytes), model=algo)
            mfu_v = msg.get("batch_mfu")
            if isinstance(mfu_v, (int, float)):
                gauge_set("tpuml_executor_mfu", float(mfu_v), model=algo)
        self.bus.publish(
            TOPIC_METRICS, {**msg, "worker_id": worker_id}, key=msg.get("subtask_id")
        )

    # ---------------- job submission ----------------

    def submit(self, subtasks: List[Dict[str, Any]], metadata: Optional[Dict[str, Any]] = None) -> None:
        for st in subtasks:
            task = dict(st)
            if metadata:
                task["metadata"] = metadata
            task["mem_estimate_mb"] = self._mem_estimate(task)
            self.bus.publish(TOPIC_TASKS, task)

    @staticmethod
    def _mem_estimate(task: Dict[str, Any]) -> float:
        try:
            from ..models.registry import get_kernel

            meta = task.get("metadata") or {}
            kernel = get_kernel(task["model_type"])
            return kernel.memory_estimate_mb(
                int(meta.get("n_rows", 1000) or 1000),
                int(meta.get("n_cols", 10) or 10),
                {},
            )
        except Exception:  # noqa: BLE001
            return 1.0

    # ---------------- internal loops ----------------

    def _ingress_loop(self) -> None:
        # priority=True: under a placement backlog, higher-QoS sessions'
        # subtasks reach the engine first (retries/requeues keep the
        # priority their spec was stamped with, so the lane survives the
        # whole retry-budget machinery)
        sub = self.bus.subscribe(TOPIC_TASKS, priority=True)
        while not self._stop.is_set():
            try:
                _, task = sub.get(timeout=0.2)
            except _queue.Empty:
                continue
            wid = self.engine.place(task)
            if wid is None:
                # no executors yet: park and retry
                time.sleep(0.1)
                self.bus.publish(TOPIC_TASKS, task)

    def _metrics_loop(self) -> None:
        sub = self.bus.subscribe(TOPIC_METRICS)
        while not self._stop.is_set():
            try:
                _, msg = sub.get(timeout=0.2)
            except _queue.Empty:
                continue
            try:
                self.engine.on_metrics(msg)
            except Exception:  # noqa: BLE001
                logger.exception("Metrics feedback failed")

    def shutdown(self) -> None:
        for wid in list(self.workers):
            self.remove_executor(wid)
        self._stop.set()
        self.engine.stop_monitor()
