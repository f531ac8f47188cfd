"""Worker agent: an executor process on the coordinator's REST control plane.

Port of the JAX package's ``runtime/agent.py`` (``WorkerAgent`` and
``main``): register with the coordinator over REST (a retry loop that
returns the worker id), heartbeat from a daemon thread, long-poll ``GET
/next_tasks/<wid>`` for the worker's keyed queue, run each batch on the
card (or the CPU with ``device="cpu"``), post every result and metrics
message back, and unsubscribe on shutdown so the queued tasks requeue.
Datasets resolve through a ``FetchingDatasetCache``: local staged copies
first, then ``GET /dataset/<id>`` from the coordinator.

The reconnecting edge is the JAX agent's: a result that fails to post is
kept in a bounded local buffer and flushed after the next successful
poll; a 404 from ``/next_tasks`` (the coordinator restarted and lost the
registry) re-registers under a fresh worker id; poll errors back off with
jitter.

A sticky CUDA error poisons the process's CUDA context, which cannot be
reset in place: the agent exits with ``DEVICE_LOST_EXIT_CODE`` for its
supervisor to start a fresh process, and the dead-worker sweep requeues
the tasks it held.

Registration reports the worker's mesh slice (``n_devices``,
``mesh_shape``: parallel/mesh.py) and receives the coordinator's prewarm
hints, which ``start`` hands to a ``PrewarmWorker`` (runtime/prewarm.py)
that warms them in the background while the executor is idle.
``run_distributed`` is the SPMD worker over a ``torch.distributed`` group:
rank 0 talks REST, every rank runs each batch on the trial mesh in
lockstep (``--distributed``).

Tracing: the agent records its spans (``agent.poll`` over the long-poll
that delivered a traced batch, the executor's ``executor.batch`` and its
phases) into a private pending ``Tracer`` and ships them after each batch
with ``POST /trace_spans/<wid>`` (``X-Trace-Id`` on the request), where the
coordinator's tracer joins them to the job's trace.
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from ..obs import TRACE_HEADER, Tracer, counter_inc, obs_enabled, process_token, span, use_tracer
from ..utils import http
from ..utils.config import get_config
from ..utils.logging import get_logger
from ..utils.serialization import json_safe
from ..utils.torch_setup import DeviceLike, resolve_device
from .executor import DeviceLostError, LocalExecutor

logger = get_logger("tpuml.agent")

#: the agent's exit status for a fatal CUDA error: any non-zero exit is
#: restartable for a supervisor, this one names the cause
DEVICE_LOST_EXIT_CODE = 13


def _exit_for_restart(context: str) -> None:
    """Fail fast on a poisoned CUDA context: exit for a supervisor to
    replace the process. The pulled tasks stay in the worker's queue at the
    coordinator and requeue by the dead-worker sweep."""
    logger.exception("%s; exiting for restart", context)
    os._exit(DEVICE_LOST_EXIT_CODE)


class WorkerAgent:
    def __init__(
        self,
        coordinator_url: str,
        *,
        device: DeviceLike = None,
        mem_capacity_mb: Optional[float] = None,
        poll_timeout_s: float = 5.0,
        max_batch: Optional[int] = None,
        register_retries: int = 10,
        register_backoff_s: float = 5.0,
        result_buffer: Optional[int] = None,
        datasets_root: Optional[str] = None,
        mesh=None,
    ):
        """``device`` defaults to the CUDA card; ``device="cpu"`` runs the
        batches on the host. ``datasets_root`` is where fetched datasets are
        staged (default: the configured storage root's). ``mesh`` (a
        TrialMesh; ``run_distributed``) makes the executor rank 0 of an
        SPMD worker and widens the registration's slice report."""
        from ..data.datasets import FetchingDatasetCache

        self.url = coordinator_url.rstrip("/")
        self.poll_timeout_s = poll_timeout_s
        self._stop = threading.Event()
        self._mem_capacity_mb = mem_capacity_mb
        self._register_retries = register_retries
        self._register_backoff_s = register_backoff_s
        if result_buffer is None:
            result_buffer = int(os.environ.get("CS230_AGENT_BUFFER", "256") or 256)
        self._buffer_max = max(int(result_buffer), 0)
        self._result_buffer: collections.deque = collections.deque()
        self._buffer_lock = threading.Lock()
        self._reconnect_lock = threading.Lock()
        self._poll_failures = 0
        #: cancel list of the most recent successful poll
        self._last_cancels: List[Dict[str, Any]] = []
        #: the executor's spans, drained and shipped after each batch
        self._tracer = Tracer(pending=True, journal=False)
        #: this worker's mesh slice, reported at every registration
        self._mesh = mesh
        #: the /subscribe response's prewarm hints and their warmer
        self._prewarm_hints: List[Dict[str, Any]] = []
        self._prewarm = None
        self.worker_id = self._register(mem_capacity_mb, register_retries, register_backoff_s)
        self.executor = LocalExecutor(
            mesh.device if mesh is not None else resolve_device(device),
            executor_id=self.worker_id, max_trials_per_batch=max_batch,
            cache=FetchingDatasetCache(self.url, root=datasets_root), mesh=mesh)
        self._threads: List[threading.Thread] = []

    # ---------------- lifecycle ----------------

    def _mesh_report(self) -> Dict[str, Any]:
        """The /subscribe slice report: the devices this worker's batches
        shard across (``mesh_info``, shared with ``add_executor``)."""
        from ..parallel.mesh import mesh_info

        n_devices, mesh_shape = mesh_info(self._mesh)
        report: Dict[str, Any] = {"n_devices": n_devices}
        if mesh_shape is not None:
            report["mesh_shape"] = mesh_shape
        return report

    def _register(self, mem_capacity_mb, retries: int, backoff_s: float) -> str:
        last_err: Optional[Exception] = None
        for attempt in range(retries):
            try:
                resp = http.request("POST", f"{self.url}/subscribe",
                                    json={"mem_capacity_mb": mem_capacity_mb,
                                          **self._mesh_report()},
                                    timeout=10).raise_for_status()
                body = resp.json()
                wid = body["worker_id"]
                self._prewarm_hints = body.get("prewarm") or []
                logger.info("Registered with coordinator as %s (%d prewarm hints)", wid,
                            len(self._prewarm_hints))
                return wid
            except Exception as e:  # noqa: BLE001 — retried
                last_err = e
                logger.warning("Registration attempt %d failed: %s", attempt + 1, e)
                time.sleep(backoff_s)
        raise ConnectionError(f"Could not register with {self.url}: {last_err}")

    def start(self) -> None:
        from .prewarm import PrewarmWorker
        from .prewarm import enabled as prewarm_enabled

        if prewarm_enabled() and self._prewarm_hints:
            # bounded, and yields to real batches (executor.busy); an SPMD
            # slice never calls start (a rank-local warm would fall out of
            # step with the collectives)
            self._prewarm = PrewarmWorker(self.executor, self._prewarm_hints)
            self._prewarm.start()
        for target in (self._run_loop, self._heartbeat_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, unsubscribe: bool = True) -> None:
        """Stop polling and heartbeating, flush parked results, unsubscribe
        (the queued tasks requeue) and join the threads."""
        self._stop.set()
        if self._prewarm is not None:
            self._prewarm.stop()
        if self._result_buffer:
            self._flush_results()
        if unsubscribe:
            try:
                http.request("POST", f"{self.url}/unsubscribe/{self.worker_id}", timeout=10)
            except http.TransportError:
                logger.exception("Unsubscribe failed")
        for t in self._threads:
            t.join(timeout=self.poll_timeout_s + 2)

    def alive(self) -> bool:
        """True while the poll thread runs."""
        return any(t.is_alive() for t in self._threads[:1])

    def run_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(1.0):
                pass
        except KeyboardInterrupt:
            self.stop()

    # ---------------- loops ----------------

    def _heartbeat_loop(self) -> None:
        interval = get_config().scheduler.heartbeat_interval_s
        while not self._stop.wait(interval):
            try:
                http.request("POST", f"{self.url}/heartbeat/{self.worker_id}", timeout=10)
            except http.TransportError:
                logger.warning("Heartbeat to %s failed", self.url)

    def _poll_tasks(self) -> List[Dict[str, Any]]:
        """One long-poll of this worker's queue; [] on a timeout or a
        transport error. A 404 means the coordinator lost the registry:
        re-register instead of polling a dead id."""
        try:
            resp = http.request(
                "GET", f"{self.url}/next_tasks/{self.worker_id}",
                params={"max": self.executor.max_trials_per_batch,
                        "timeout": self.poll_timeout_s},
                timeout=self.poll_timeout_s + 10)
            if resp.status == 404:
                logger.warning("Coordinator no longer knows worker %s (restart?); "
                               "re-registering", self.worker_id)
                self._resubscribe()
                return []
            body = resp.raise_for_status().json()
            tasks = body.get("tasks", [])
            # cooperative cancels: the executor stops them at its next
            # group boundary
            self._last_cancels = body.get("cancel") or []
            if self._last_cancels:
                self.executor.cancel(self._last_cancels)
        except Exception:  # noqa: BLE001 — transport or server error: back off
            self._poll_failures += 1
            backoff = min(10.0, 0.5 * 2 ** min(self._poll_failures - 1, 5)) * (
                0.5 + random.random())
            logger.warning("Task poll failed (%d consecutive); backing off %.2fs",
                           self._poll_failures, backoff)
            self._stop.wait(backoff)
            return []
        self._poll_failures = 0
        if self._result_buffer:
            # the coordinator answered: drain the parked results first
            self._flush_results()
        return tasks

    # ---------------- reconnecting edge ----------------

    def _resubscribe(self) -> bool:
        with self._reconnect_lock:
            old = self.worker_id
            try:
                wid = self._register(self._mem_capacity_mb, self._register_retries,
                                     self._register_backoff_s)
            except ConnectionError:
                logger.error("Re-registration with %s failed; will retry on the next poll",
                             self.url)
                return False
            self.worker_id = wid
            self.executor.executor_id = wid
            self._poll_failures = 0
            counter_inc("tpuml_agent_reconnects_total")
            logger.info("Re-registered after coordinator restart: %s -> %s", old, wid)
        self._flush_results()
        return True

    def _buffer_result(self, stid: str, payload: Dict[str, Any]) -> None:
        with self._buffer_lock:
            if self._buffer_max <= 0:
                counter_inc("tpuml_agent_results_dropped_total")
                return
            while len(self._result_buffer) >= self._buffer_max:
                dropped, _ = self._result_buffer.popleft()
                counter_inc("tpuml_agent_results_dropped_total")
                logger.warning("Result buffer full (%d); dropping the oldest result %s",
                               self._buffer_max, dropped)
            self._result_buffer.append((stid, payload))
        counter_inc("tpuml_agent_results_buffered_total")
        logger.warning("Result post failed for %s; buffered locally (%d pending)",
                       stid, len(self._result_buffer))

    def _flush_results(self) -> None:
        """Post the buffered results in order; stop at the first transport
        failure. A result the coordinator rejects for good (4xx but 404)
        is dropped: its subtask re-runs by the lease and recovery paths."""
        while True:
            with self._buffer_lock:
                if not self._result_buffer:
                    return
                stid, payload = self._result_buffer.popleft()
            try:
                resp = http.request("POST", f"{self.url}/task_result/{self.worker_id}",
                                    json=payload, timeout=30)
                if 400 <= resp.status < 500 and resp.status != 404:
                    counter_inc("tpuml_agent_results_dropped_total")
                    logger.error("Buffered result %s permanently rejected (%d); dropping it",
                                 stid, resp.status)
                    continue
                resp.raise_for_status()
            except Exception:  # noqa: BLE001 — transient: keep the buffer
                with self._buffer_lock:
                    self._result_buffer.appendleft((stid, payload))
                logger.warning("Buffered-result flush failed at %s; %d still parked",
                               stid, len(self._result_buffer))
                return

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            t_poll = time.time()
            tasks = self._poll_tasks()
            if not tasks:
                continue
            tid = next((t.get("trace_id") for t in tasks if t.get("trace_id")), None)
            if tid and obs_enabled():
                # back-dated over the long-poll that delivered the batch
                with span("agent.poll", trace_id=tid, parent_id=None, tracer=self._tracer,
                          worker=self.worker_id, n_tasks=len(tasks)) as sp:
                    sp.start = t_poll
            try:
                with use_tracer(self._tracer):
                    self.executor.run_subtasks(tasks, on_result=self._post_result,
                                               on_metrics=self._post_metrics)
            except DeviceLostError:
                _exit_for_restart(f"Agent {self.worker_id} lost its CUDA context")
            finally:
                self._ship_spans()

    def _ship_spans(self) -> None:
        """Ship the spans recorded here to the coordinator's tracer (``POST
        /trace_spans/<wid>``, ``X-Trace-Id`` on the request): the return
        leg of the trace propagation. Best-effort: a lost batch of spans
        degrades the timeline, never the job."""
        spans = self._tracer.drain()
        if not spans:
            return
        try:
            http.request("POST", f"{self.url}/trace_spans/{self.worker_id}",
                         json={"spans": json_safe(spans)},
                         headers={TRACE_HEADER: spans[0].get("trace_id", "")}, timeout=10)
        except http.TransportError:
            logger.warning("Span shipping failed (%d spans dropped)", len(spans))

    def _post_result(self, stid: str, status: str, result: Optional[Dict[str, Any]]) -> None:
        # obs_pid rides the wire only: the coordinator counts the outcomes
        # of other processes, not of an agent in its own
        payload = {**json_safe(result), "obs_pid": process_token()}
        try:
            http.request("POST", f"{self.url}/task_result/{self.worker_id}", json=payload,
                         timeout=30).raise_for_status()
        except Exception:  # noqa: BLE001 — park it for the next successful poll
            self._buffer_result(stid, payload)

    def _post_metrics(self, msg: Dict[str, Any]) -> None:
        try:
            http.request("POST", f"{self.url}/task_metrics/{self.worker_id}",
                         json=json_safe(msg), timeout=30)
        except http.TransportError:
            logger.exception("Metrics post failed")


def _prefetch_agree(executor, tasks, mesh) -> List[str]:
    """Stage every dataset of a batch before the sharded region, and agree
    across the ranks on the ones that failed anywhere (JAX
    ``_prefetch_agree``). A dataset fetch that failed on only some ranks
    would send those ranks past the batch's collectives while the others
    entered them: a hang. Each rank stages each dataset and reports its
    ``(rows, cols)`` signature, (0, 0) for a failure; the signatures are
    all-gathered, and a dataset with a failure or with differing shapes on
    any rank is failed on every rank, outside any collective. Returns those
    dataset ids."""
    import numpy as np

    from ..models.registry import get_kernel
    from ..parallel.distributed import all_gather_ints

    wanted: Dict[str, str] = {}
    for st in tasks:
        wanted.setdefault(st["dataset_id"], st["model_type"])
    sig = np.zeros((len(wanted), 2), np.int64)
    for i, (did, model_type) in enumerate(wanted.items()):
        try:
            data = executor.cache.get(did, get_kernel(model_type).task)
            sig[i] = data.X.shape[:2]
        except Exception:  # noqa: BLE001 — the zero signature carries it
            logger.exception("Prefetch failed for dataset %r", did)
    all_sig = all_gather_ints(sig.reshape(-1), mesh).reshape(-1, len(wanted), 2)
    bad = []
    for i, did in enumerate(wanted):
        rank_sigs = all_sig[:, i, :]
        if (rank_sigs == 0).all(axis=1).any() or len({tuple(s) for s in rank_sigs}) > 1:
            bad.append(did)
    return bad


def _slice_watchdog(url: str, slice_id: str, rank: int, n_proc: int) -> None:
    """Per-rank liveness of an SPMD slice (a daemon thread on every rank).

    A killed rank leaves its siblings blocked in a collective, while the
    primary's worker heartbeats go on from their own thread, so the
    coordinator would never see the slice die. So each rank heartbeats
    ``POST /slice_heartbeat/<slice>/<rank>`` and reads its siblings' ages;
    a sibling older than the scheduler's ``dead_after_s`` (or missing that
    long after a startup grace) ends this rank too. The primary's death
    stops the worker heartbeats, the dead-worker sweep requeues the pulled
    tasks, and the whole slice is relaunched: a lone rank cannot rejoin a
    ``torch.distributed`` group."""
    cfg = get_config().scheduler
    interval = cfg.heartbeat_interval_s
    dead_after = max(cfg.dead_after_s, 2 * interval)
    grace_until = time.time() + 6 * dead_after
    # a sibling missing from the table (a coordinator restart empties it)
    # counts as dead only once it stays missing for dead_after
    missing_since: Dict[int, float] = {}
    while True:
        try:
            http.request("POST", f"{url}/slice_heartbeat/{slice_id}/{rank}", timeout=10)
            resp = http.request("GET", f"{url}/slice_status/{slice_id}", timeout=10)
            ages = {int(r): float(a) for r, a in (resp.json().get("ranks") or {}).items()}
        except Exception:  # noqa: BLE001 — an unreachable coordinator: the
            # worker heartbeat path owns that failure
            time.sleep(interval)
            continue
        now = time.time()
        for sib in range(n_proc):
            if sib == rank:
                continue
            age = ages.get(sib)
            if age is None:
                if now <= grace_until:
                    continue
                first = missing_since.setdefault(sib, now)
                if now - first <= dead_after:
                    continue
            else:
                missing_since.pop(sib, None)
                if age <= dead_after:
                    continue
            logger.error("SPMD slice %s: rank %d lost sibling rank %d (age %s, threshold "
                         "%.1fs); exiting for a slice restart", slice_id, rank, sib, age,
                         dead_after)
            os._exit(DEVICE_LOST_EXIT_CODE)
        time.sleep(interval)


def run_distributed(url: str, *, device: DeviceLike = None,
                    mem_capacity_mb: Optional[float] = None, max_batch: Optional[int] = None,
                    poll_timeout_s: float = 5.0, datasets_root: Optional[str] = None) -> None:
    """An SPMD worker over a trial mesh of every rank of the process group
    (JAX ``run_distributed``). Call after
    ``parallel.distributed.init_distributed`` on every rank.

    Rank 0 alone talks REST: it registers one worker (its mesh-slice
    report: the group's size), heartbeats, long-polls tasks and posts the
    results. Every rank, 0 included, runs each batch on the mesh in
    lockstep: each pulled batch (with its cancel list) reaches the other
    ranks by ``broadcast_json``, the datasets are staged and agreed on
    (``_prefetch_agree``), and the trial engine shards every chunk over the
    ranks and gathers the outputs on each. ``device`` is where this rank
    runs: None is a card of this host (a rank that finds none raises),
    ``"cpu"`` the host.

    SIGINT / SIGTERM on rank 0 broadcasts a stop at the next rendezvous,
    and every rank returns. A fatal CUDA error on any rank exits that
    process non-zero; its siblings' next collective fails or times out, or
    the slice watchdog ends them, and the whole group must be relaunched:
    a lone respawned rank cannot rejoin a ``torch.distributed`` group. A
    rendezvous collective that fails (gloo reports a lost peer at once)
    ends the rank as the watchdog does, with ``DEVICE_LOST_EXIT_CODE`` and
    without unsubscribing: rank 0's worker heartbeats stop, and the
    dead-worker sweep requeues the slice's pulled tasks."""
    import signal
    import uuid

    from ..data.datasets import FetchingDatasetCache
    from ..parallel.distributed import (
        LOST_PEER_ERRORS,
        broadcast_json,
        is_primary,
        process_count,
    )
    from ..parallel.mesh import trial_mesh

    mesh = trial_mesh(device=device)
    n_proc = process_count()
    logger.info("Distributed agent: rank %d/%d on %s", mesh.rank, n_proc, mesh.device)
    if n_proc > 1:
        sid_msg = broadcast_json({"slice_id": uuid.uuid4().hex[:12]} if is_primary() else None)
        threading.Thread(target=_slice_watchdog,
                         args=(url.rstrip("/"), sid_msg["slice_id"], mesh.rank, n_proc),
                         daemon=True).start()

    agent: Optional[WorkerAgent] = None
    if is_primary():
        try:
            agent = WorkerAgent(url, device=mesh.device, mesh=mesh,
                                mem_capacity_mb=mem_capacity_mb, poll_timeout_s=poll_timeout_s,
                                max_batch=max_batch, datasets_root=datasets_root)
        except Exception:
            # the other ranks wait at their first broadcast: release them
            logger.exception("Primary registration failed; stopping the slice")
            broadcast_json({"tasks": [], "stop": True})
            raise

        def _on_signal(signum, frame):
            agent._stop.set()

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread
                pass
        threading.Thread(target=agent._heartbeat_loop, daemon=True).start()
        executor = agent.executor
        post_result, post_metrics = agent._post_result, agent._post_metrics
    else:
        executor = LocalExecutor(mesh.device, mesh=mesh, executor_id=f"spmd-rank{mesh.rank}",
                                 max_trials_per_batch=max_batch,
                                 cache=FetchingDatasetCache(url.rstrip("/"), root=datasets_root))
        post_result = post_metrics = lambda *a, **k: None

    try:
        while True:
            msg = None
            if agent is not None:
                stop = agent._stop.is_set()
                # the cancel list rides with the tasks: every rank must
                # filter the same set or the collectives fall out of step
                msg = {"tasks": [] if stop else agent._poll_tasks(), "stop": stop,
                       "cancel": agent._last_cancels}
            try:
                msg = broadcast_json(msg)  # the lockstep rendezvous, every iteration
            except LOST_PEER_ERRORS:  # a lost rank: the slice is relaunched whole
                _exit_for_restart(f"SPMD rank {mesh.rank} lost a sibling at the rendezvous")
            if msg["stop"]:
                break
            if msg.get("cancel") and agent is None:
                executor.cancel(msg["cancel"])
            tasks = msg["tasks"]
            if not tasks:
                continue
            try:
                bad = _prefetch_agree(executor, tasks, mesh)
            except LOST_PEER_ERRORS:  # as at the rendezvous
                _exit_for_restart(f"SPMD rank {mesh.rank} lost a sibling agreeing on datasets")
            if bad:
                # the same branch on every rank, outside any collective
                for st in [t for t in tasks if t["dataset_id"] in bad]:
                    post_result(st["subtask_id"], "failed", {
                        "subtask_id": st["subtask_id"], "job_id": st.get("job_id"),
                        "model_type": st["model_type"], "parameters": st["parameters"],
                        "status": "failed", "attempt": int(st.get("attempt") or 0),
                        "error": f"dataset {st['dataset_id']!r} unavailable on the slice"})
                tasks = [t for t in tasks if t["dataset_id"] not in bad]
            if not tasks:
                continue
            try:
                if agent is not None:
                    with use_tracer(agent._tracer):
                        executor.run_subtasks(tasks, on_result=post_result,
                                              on_metrics=post_metrics)
                    agent._ship_spans()
                else:
                    executor.run_subtasks(tasks, on_result=post_result, on_metrics=post_metrics)
            except DeviceLostError as e:  # a poisoned context, or a sibling lost in a batch
                _exit_for_restart(f"SPMD rank {mesh.rank} left its slice ({e})")
    except KeyboardInterrupt:
        if agent is not None:
            agent._stop.set()
    finally:
        if agent is not None:
            agent.stop()


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m cs230_distributed_machine_learning_tpu_torch.runtime.agent
    --url http://coordinator:5001``: one agent on this host's card, or on
    its CPU with ``--device cpu``.

    An SPMD worker over several ranks: start one process a rank with
    ``--distributed --coordinator-address HOST:PORT --num-processes N
    --process-id I`` (the rendezvous address, not the REST url); rank 0
    talks to the coordinator. ``--backend`` overrides the rule (nccl when
    every local rank has a card of its own, else gloo)."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuml worker agent")
    parser.add_argument("--url", required=True, help="coordinator base URL")
    parser.add_argument("--mem-mb", type=float, default=None)
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="the device the batches run on (default: the CUDA card; "
                             "'cpu' for the host)")
    parser.add_argument("--distributed", action="store_true",
                        help="one rank of an SPMD worker over a torch.distributed group")
    parser.add_argument("--coordinator-address", default=None,
                        help="the process group's rendezvous host:port (not the REST url)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend (default: the rule)")
    parser.add_argument("--local-devices", type=int, default=None,
                        help="refused: a rank of the PyTorch package is one device")
    args = parser.parse_args(argv)
    if args.local_devices is not None:
        parser.error("--local-devices (virtual devices in one process) has no counterpart: "
                     "a rank is one process on one device; start one process a rank")
    if args.distributed:
        if not (args.coordinator_address and args.num_processes and args.process_id is not None):
            parser.error("--distributed needs --coordinator-address, --num-processes and "
                         "--process-id")
        from ..parallel.distributed import init_distributed, shutdown

        backend = init_distributed(args.coordinator_address, args.num_processes,
                                   args.process_id, backend=args.backend, device=args.device)
        logger.info("Rank %d of %d joined a %s group", args.process_id, args.num_processes,
                    backend)
        try:
            run_distributed(args.url, device=args.device, mem_capacity_mb=args.mem_mb,
                            max_batch=args.max_batch)
        finally:
            shutdown()
        return
    agent = WorkerAgent(args.url, device=args.device, mem_capacity_mb=args.mem_mb,
                        max_batch=args.max_batch)
    agent.run_forever()


if __name__ == "__main__":
    main()
