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
the tasks it held. The JAX agent's multi-process mesh (``--distributed``)
is not ported.

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
    ):
        """``device`` defaults to the CUDA card; ``device="cpu"`` runs the
        batches on the host. ``datasets_root`` is where fetched datasets are
        staged (default: the configured storage root's)."""
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
        self.worker_id = self._register(mem_capacity_mb, register_retries, register_backoff_s)
        self.executor = LocalExecutor(
            resolve_device(device), executor_id=self.worker_id, max_trials_per_batch=max_batch,
            cache=FetchingDatasetCache(self.url, root=datasets_root))
        self._threads: List[threading.Thread] = []

    # ---------------- lifecycle ----------------

    def _register(self, mem_capacity_mb, retries: int, backoff_s: float) -> str:
        last_err: Optional[Exception] = None
        for attempt in range(retries):
            try:
                resp = http.request("POST", f"{self.url}/subscribe",
                                    json={"mem_capacity_mb": mem_capacity_mb, "n_devices": 1},
                                    timeout=10).raise_for_status()
                wid = resp.json()["worker_id"]
                logger.info("Registered with coordinator as %s", wid)
                return wid
            except Exception as e:  # noqa: BLE001 — retried
                last_err = e
                logger.warning("Registration attempt %d failed: %s", attempt + 1, e)
                time.sleep(backoff_s)
        raise ConnectionError(f"Could not register with {self.url}: {last_err}")

    def start(self) -> None:
        for target in (self._run_loop, self._heartbeat_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, unsubscribe: bool = True) -> None:
        """Stop polling and heartbeating, flush parked results, unsubscribe
        (the queued tasks requeue) and join the threads."""
        self._stop.set()
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


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m cs230_distributed_machine_learning_tpu_torch.runtime.agent
    --url http://coordinator:5001``: one agent on this host's card, or on
    its CPU with ``--device cpu``."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuml worker agent")
    parser.add_argument("--url", required=True, help="coordinator base URL")
    parser.add_argument("--mem-mb", type=float, default=None)
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="the device the batches run on (default: the CUDA card; "
                             "'cpu' for the host)")
    parser.add_argument("--distributed", action="store_true",
                        help="not ported: a multi-process mesh across hosts")
    args = parser.parse_args(argv)
    if args.distributed:
        parser.error("--distributed (a multi-process mesh) is not ported to the PyTorch "
                     "package yet")
    agent = WorkerAgent(args.url, device=args.device, mem_capacity_mb=args.mem_mb,
                        max_batch=args.max_batch)
    agent.run_forever()


if __name__ == "__main__":
    main()
