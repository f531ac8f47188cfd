"""Trial executor: runs subtask batches on the local device.

Port of ``LocalExecutor.run_subtasks`` / ``_run_group`` of the JAX
package's ``runtime/executor.py``: subtasks are grouped by (dataset,
model type) and each group runs as one call of the trial engine
(parallel/trial_map.py). Per-subtask results and metrics messages keep
the reference's schema; in each group, ``on_result`` and then
``on_metrics`` fire per subtask in the group's order (the rung
controller's promotions depend on the order of the reports). A group that
raises (unknown or not-yet-ported model, missing dataset, unsupported
scoring) fails its subtasks with the error text; the job goes on.

Adaptive search rides three more pieces of the JAX executor: the
cooperative cancel (``cancel``, checked at each group boundary, where a
cancelled attempt is posted as a terminal ``pruned`` result instead of
running), the ``asha`` stamp echoed on each result, and the rung fields
of the metrics message. A callable ``scoring`` takes the host-side path
(``run_trials_callable``). ``fit_artifact`` refits a job's winner for its
artifact.

The scheduled runtime adds the JAX executor's fault containment: a batch
that fails with a process-fatal CUDA error (``_is_device_fatal``: a sticky
error that poisons the context for every later launch) raises
``DeviceLostError`` instead of failing its subtasks, so the owning worker
leaves the pool and its tasks are requeued; ``FaultInjector`` scripts
delays, failures, dropped results and device losses; ``ResourceSampler``
fills the metrics message's host and device resource fields.

Observability (JAX ``executor.py``): a batch whose subtasks carry a trace
id runs inside an ``executor.batch`` span, and the trial engine's phase
timers become its synthesized ``executor.{compile,stage,dispatch,fetch}``
children; every batch feeds ``tpuml_executor_device_seconds_total{phase}``,
``tpuml_executor_{flops,bytes}_total``, ``tpuml_executor_mfu`` and the HBM
gauges, and its cost record (``batch_cost``) rides the batch's first
result into the job store, where ``Coordinator.job_cost`` sums it. The
metrics messages carry the batch's ``batch_*`` totals and ``obs_pid`` for
the coordinator's ingest of remote batches.

Over a trial mesh (``mesh=``, parallel/mesh.py) the executor is one rank of
an SPMD worker: the engine shards each chunk over the ranks, the result at
the mesh collective's winner carries ``device_argmax`` (the coordinator's
``winner_via``), and the batch's MFU divides its FLOPs by the peak of every
rank's card. ``prewarm_hint`` warms one coordinator hint (runtime/
prewarm.py); ``busy`` is true while a batch runs, so a prewarm yields.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import DatasetCache
from ..models.registry import get_kernel
from ..obs import (
    counter_inc,
    gauge_set,
    obs_enabled,
    observe,
    process_token,
    record_batch_device_seconds,
    record_phase,
    span,
)
from ..ops.folds import build_split_plan
from ..parallel.distributed import LockstepLostError, agree
from ..parallel.trial_map import TrialRunResult, fit_single, run_trials, run_trials_callable
from ..utils.config import get_config
from ..utils.flops import device_memory_stats
from ..utils.flops import mfu as _mfu
from ..utils.logging import get_logger

logger = get_logger("tpuml.executor")

ResultCallback = Callable[[str, str, Optional[Dict[str, Any]]], None]
MetricsCallback = Callable[[Dict[str, Any]], None]

#: the executor id of the direct-mode executor, on its metrics messages
EXECUTOR_ID = "local"


def record_hbm_gauges() -> None:
    """Refresh ``tpuml_device_hbm_bytes{kind=used|peak|limit}`` from the
    card's memory stats. The CPU has none: the family stays at its
    registered zero. Called after every executed batch and at
    /metrics/prom scrape time."""
    if not obs_enabled():
        return
    stats = device_memory_stats()
    for kind, key in (
        ("used", "bytes_in_use"),
        ("peak", "peak_bytes_in_use"),
        ("limit", "bytes_limit"),
    ):
        v = stats.get(key)
        if v is not None:
            gauge_set("tpuml_device_hbm_bytes", float(v), kind=kind)


class ResourceSampler:
    """Background CPU / host-memory sampling at a fixed cadence during a
    batch, and the batch's peak device memory. The CPU and memory averages
    are two of the runtime predictor's features; they come from psutil and
    stay None where psutil is not installed, as in the JAX package. The
    device peak is ``device_memory_stats()``'s ``peak_bytes_in_use`` since
    the batch began (the allocator's peak is reset on entry); None on the
    CPU."""

    def __init__(self, device: Optional[torch.device] = None, interval_s: float = 0.5):
        self.device = device
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cpu: List[float] = []
        self._mem: List[float] = []
        self._dev_peak_mb: Optional[float] = None

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _loop(self) -> None:
        try:
            import psutil
        except ImportError:
            return
        psutil.cpu_percent(interval=None)  # prime the delta-based counter
        while not self._stop.wait(self.interval_s):
            self._cpu.append(psutil.cpu_percent(interval=None))
            self._mem.append(psutil.virtual_memory().percent)

    def __enter__(self) -> "ResourceSampler":
        if self._on_card():
            torch.cuda.reset_peak_memory_stats(self.device)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
        if self._on_card() and exc[0] is None:
            peak = device_memory_stats().get("peak_bytes_in_use")
            if peak is not None:
                self._dev_peak_mb = peak / 1e6

    def averages(self) -> Dict[str, Optional[float]]:
        """Averaged samples; one instantaneous reading when the batch ended
        inside the first sampling interval."""
        cpu = mem = None
        if self._cpu:
            cpu = float(sum(self._cpu) / len(self._cpu))
            mem = float(sum(self._mem) / len(self._mem))
        else:
            try:
                import psutil

                cpu = psutil.cpu_percent(interval=None)
                mem = psutil.virtual_memory().percent
            except ImportError:
                pass
        return {"cpu_percent_avg": cpu, "mem_percent_avg": mem,
                "device_peak_mem_mb": self._dev_peak_mb}


class DeviceLostError(RuntimeError):
    """The executor's CUDA context is poisoned: every later launch in this
    process fails, so the owning worker leaves the pool instead of posting
    per-task failures. A CUDA context cannot be reset inside a process, so
    a remote agent (runtime/agent.py) exits with ``DEVICE_LOST_EXIT_CODE``
    for its supervisor to replace it, and an in-process worker
    (runtime/cluster.py) stops without unsubscribing, so the dead-worker
    sweep requeues its tasks onto the survivors."""


#: the sticky CUDA errors (cudaError_t codes) after which the context fails
#: every later launch: illegal address, device-side assert, hardware stack
#: error, illegal instruction, misaligned address, invalid address space,
#: invalid PC, launch failure, uncorrectable ECC
_STICKY_CUDA_CODES = frozenset({700, 710, 714, 715, 716, 717, 718, 719, 214})
#: PyTorch's spelling of the same errors ("CUDA error: <cudaGetErrorString>")
_STICKY_CUDA_TEXT = (
    "an illegal memory access was encountered",
    "device-side assert triggered",
    "hardware stack error",
    "an illegal instruction was encountered",
    "misaligned address",
    "operation not supported on global/shared address space",
    "invalid program counter",
    "unspecified launch failure",
    "uncorrectable ECC error encountered",
)
#: the kernels' wrappers: "... failed: CUDA error <code>"
_CODE_RE = re.compile(r"CUDA error (\d+)")


def _is_device_fatal(e: BaseException) -> bool:
    """True for a process-fatal CUDA error in either spelling: a port
    kernel's ``RuntimeError("... failed: CUDA error <code>")`` with a sticky
    code, or PyTorch's ``"CUDA error: <text>"`` for one. Out-of-memory
    (``torch.OutOfMemoryError``, code 2) and every other error stay
    task-level."""
    if isinstance(e, DeviceLostError):
        return True
    if isinstance(e, torch.OutOfMemoryError):
        return False
    msg = str(e)
    if any(int(code) in _STICKY_CUDA_CODES for code in _CODE_RE.findall(msg)):
        return True
    return "CUDA error" in msg and any(t in msg for t in _STICKY_CUDA_TEXT)


class FaultInjector:
    """Test and chaos hooks, as in the JAX package: delay a batch, fail N
    batches (task-level), drop the results of N batches silently (the
    hung-worker case the lease layer recovers), or lose the device
    (process-level), at once or after N healthy batches
    (``device_lost_after``). ``only_worker=`` scopes every mode to one
    executor id."""

    def __init__(self, delay_s: float = 0.0, fail_batches: int = 0,
                 device_lost: bool = False, device_lost_after: Optional[int] = None,
                 drop_results: int = 0, only_worker: Optional[str] = None):
        self.delay_s = delay_s
        self.fail_batches = fail_batches
        self.device_lost = device_lost
        self.device_lost_after = device_lost_after
        self.drop_results = drop_results
        self.only_worker = only_worker
        self._batches_seen = 0

    def _targets(self, executor_id: str) -> bool:
        return self.only_worker is None or executor_id == self.only_worker

    def before_batch(self, executor_id: str, model_type: str) -> None:
        if not self._targets(executor_id):
            return
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.device_lost or (self.device_lost_after is not None
                                and self._batches_seen >= self.device_lost_after):
            raise DeviceLostError(f"fault injection: simulated device loss on {executor_id}")
        if self.fail_batches > 0:
            self.fail_batches -= 1
            raise RuntimeError(f"fault injection: simulated batch failure on {executor_id}")
        self._batches_seen += 1  # only batches that passed injection count

    def drop_batch_results(self, executor_id: str) -> bool:
        """True when this batch's results and metrics must be dropped
        (consumes one ``drop_results`` unit)."""
        if not self._targets(executor_id):
            return False
        if self.drop_results > 0:
            self.drop_results -= 1
            return True
        return False


class LocalExecutor:
    """Executes trial batches on ``device``."""

    def __init__(
        self,
        device: torch.device,
        *,
        cache: Optional[DatasetCache] = None,
        max_trials_per_batch: Optional[int] = None,
        executor_id: str = EXECUTOR_ID,
        fault_injector: Optional[FaultInjector] = None,
        mesh=None,
    ):
        #: the trial mesh this executor is one rank of (None: one device);
        #: its rank's device replaces ``device``
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else device
        #: the worker id on results and metrics messages (a cluster sets it
        #: to the worker id the placement engine minted)
        self.executor_id = executor_id
        self.fault_injector = fault_injector
        self.cache = cache or DatasetCache()
        self.max_trials_per_batch = (
            max_trials_per_batch or get_config().execution.max_trials_per_batch
        )
        #: cooperative-cancel set (docs/SEARCH.md): subtask_id -> highest
        #: cancelled attempt, consumed at the next group boundary
        self._cancel_lock = threading.Lock()
        self._cancelled: Dict[str, int] = {}
        #: batches in flight (``busy``: a prewarm yields while one runs)
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    @property
    def busy(self) -> bool:
        """True while a batch runs on this executor."""
        return self._inflight > 0

    def cancel(self, items) -> None:
        """Mark attempts cancelled. ``items``: dicts with ``subtask_id``
        (and optionally ``attempt``) or bare subtask ids. A matching trial
        that has not started stops at the next group boundary and posts a
        terminal ``pruned`` result; a group already on the card finishes
        (cancellation is between groups, never mid-kernel)."""
        with self._cancel_lock:
            for item in items or []:
                stid = item.get("subtask_id") if isinstance(item, dict) else item
                if not stid:
                    continue
                attempt = int(item.get("attempt") or 0) if isinstance(item, dict) else 0
                self._cancelled[stid] = max(self._cancelled.get(stid, 0), attempt)
            while len(self._cancelled) > 4096:  # bound the set
                self._cancelled.pop(next(iter(self._cancelled)))

    def _take_cancelled(self, subtasks, idxs):
        """Split a group into (live, cancelled) index lists; cancelled
        entries are consumed from the set. A task stamped with a higher
        attempt than the cancel survives it (a legitimately re-issued
        attempt)."""
        with self._cancel_lock:
            if not self._cancelled:
                return idxs, []
            live, cancelled = [], []
            for gi in idxs:
                st = subtasks[gi]
                marked = self._cancelled.get(st["subtask_id"])
                if marked is not None and int(st.get("attempt") or 0) <= marked:
                    cancelled.append(gi)
                    self._cancelled.pop(st["subtask_id"], None)
                else:
                    live.append(gi)
        return live, cancelled

    def _post_pruned(self, st, results, gi, on_result, on_metrics) -> None:
        """Terminal ``pruned`` result for a cancelled attempt: the trial
        never runs. Its metrics message carries no timing and
        ``cancelled: true``."""
        result = {
            "subtask_id": st["subtask_id"],
            "job_id": st.get("job_id"),
            "model_type": st.get("model_type"),
            "parameters": st.get("parameters"),
            "status": "pruned",
            "pruned": True,
            "prune_reason": "cancelled",
            "attempt": int(st.get("attempt") or 0),
        }
        if st.get("asha"):
            result["asha"] = dict(st["asha"])
        results[gi] = result
        counter_inc("tpuml_subtasks_pruned_total")
        logger.info("Cancelled subtask %s pruned at the group boundary", st["subtask_id"])
        if on_result:
            on_result(st["subtask_id"], "pruned", result)
        if on_metrics:
            on_metrics({"worker_id": self.executor_id, "subtask_id": st["subtask_id"],
                        "status": "PRUNED", "cancelled": True, "algo": st.get("model_type")})

    def run_subtasks(
        self,
        subtasks: List[Dict[str, Any]],
        *,
        on_result: Optional[ResultCallback] = None,
        on_metrics: Optional[MetricsCallback] = None,
    ) -> List[Dict[str, Any]]:
        """Run subtasks grouped by (dataset, model_type); returns results in
        input order. Per subtask, as its group completes, ``on_result``
        fires and then ``on_metrics`` with its metrics message."""
        with self._inflight_lock:
            self._inflight += 1
        try:
            return self._run_subtasks(subtasks, on_result, on_metrics)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _run_subtasks(self, subtasks, on_result, on_metrics) -> List[Dict[str, Any]]:
        results: List[Optional[Dict[str, Any]]] = [None] * len(subtasks)
        groups: Dict[Any, List[int]] = {}
        for i, st in enumerate(subtasks):
            groups.setdefault((st["dataset_id"], st["model_type"]), []).append(i)

        for (dataset_id, model_type), idxs in groups.items():
            # cooperative cancel, checked at every group boundary
            idxs, cancelled = self._take_cancelled(subtasks, idxs)
            for gi in cancelled:
                self._post_pruned(subtasks[gi], results, gi, on_result, on_metrics)
            if not idxs:
                continue
            received_at = time.time()
            # the batch rides the submitting job's trace (the coordinator
            # stamps its id into each spec); a spec with none opens no span
            tid = next((subtasks[i].get("trace_id") for i in idxs
                        if subtasks[i].get("trace_id")), None)
            batch_cm = (span("executor.batch", trace_id=tid, worker=self.executor_id,
                             model_type=model_type, dataset_id=dataset_id,
                             n_subtasks=len(idxs))
                        if tid else contextlib.nullcontext(None))
            try:
                with batch_cm as batch_sp:
                    self._run_group(subtasks, idxs, dataset_id, model_type, received_at,
                                    results, on_result, on_metrics, batch_sp)
            except Exception as e:  # noqa: BLE001 — task-level failure semantics
                if _is_device_fatal(e) or isinstance(e, LockstepLostError):
                    # a poisoned context fails every later launch, and a mesh
                    # rank out of step with its siblings cannot rejoin them:
                    # post no per-task failures (the owner keeps the tasks
                    # queued for the dead-worker requeue) and escalate
                    raise DeviceLostError(
                        f"device lost on {self.executor_id}: {e}") from e
                logger.exception("Batch failed for %s/%s", dataset_id, model_type)
                for gi in idxs:
                    st = subtasks[gi]
                    result = {
                        "subtask_id": st["subtask_id"],
                        "job_id": st.get("job_id"),
                        "model_type": model_type,
                        "parameters": st["parameters"],
                        "status": "failed",
                        "error": str(e),
                        "attempt": int(st.get("attempt") or 0),
                    }
                    if st.get("speculative"):
                        result["speculative"] = True
                    results[gi] = result
                    counter_inc("tpuml_subtasks_failed_total")
                    if on_result:
                        on_result(st["subtask_id"], "failed", result)
        return results  # type: ignore[return-value]

    def _run_group(self, subtasks, idxs, dataset_id, model_type, received_at, results,
                   on_result, on_metrics=None, batch_sp=None) -> None:
        """One (dataset, model_type) group on the trial engine, then its
        per-subtask results and metrics messages. ``batch_sp`` is the
        enclosing ``executor.batch`` span (or None); the engine's phase
        timers become its synthesized children."""
        try:
            if self.fault_injector is not None:
                self.fault_injector.before_batch(self.executor_id, model_type)
            kernel = get_kernel(model_type)
            data = self.cache.get(dataset_id, kernel.task)
            tp = subtasks[idxs[0]].get("train_params", {}) or {}
            scoring = _normalize_scoring(tp.get("scoring"), kernel.task, data.n_classes, kernel)
            plan = build_split_plan(
                np.asarray(data.y),
                task=kernel.task,
                n_folds=_coerce_cv(tp.get("cv")),
                test_size=float(tp.get("test_size", get_config().execution.default_test_size)),
                random_state=tp.get("random_state", 42),
            )
        except Exception:
            if self.mesh is not None:
                # the siblings' run_trials agrees on its rank-local part
                # before any collective: this rank's verdict meets them there
                agree(False, self.mesh)
            raise
        started_at = time.time()
        params = [subtasks[i]["parameters"] for i in idxs]
        with ResourceSampler(self.device) as sampler:
            run = self._run_trials(kernel, data, plan, params, scoring)
        finished_at = time.time()
        if self.fault_injector is not None and self.fault_injector.drop_batch_results(
                self.executor_id):
            # the hung-worker case: the batch ran, but no result or metrics
            # message leaves this executor (the lease layer recovers them)
            logger.warning("FaultInjector: dropping the results of a %d-trial %s batch on %s",
                           len(idxs), model_type, self.executor_id)
            return
        observe("tpuml_executor_dispatch_seconds", run.run_time_s)
        record_batch_device_seconds(run.compile_time_s, run.stage_time_s,
                                    run.run_time_s, run.fetch_time_s)
        resources = sampler.averages()
        batch_cost = self._record_batch_cost(run, model_type, dataset_id, len(idxs), resources,
                                             n_devices=self._n_devices())
        self._record_batch_phases(batch_sp, run, started_at, batch_cost)
        per_trial_time = run.run_time_s / max(len(idxs), 1)
        # the mesh collective's winner within the group (submission order)
        device_best_pos = run.device_best[0] if run.device_best is not None else None
        for j, gi in enumerate(idxs):
            st = subtasks[gi]
            result = {
                "subtask_id": st["subtask_id"],
                "job_id": st.get("job_id"),
                "model_type": model_type,
                "parameters": st["parameters"],
                "search_params": st.get("search_params"),
                "training_time": per_trial_time,
                "status": "completed",
                "attempt": int(st.get("attempt") or 0),
                **run.trial_metrics[j],
            }
            if st.get("asha"):
                # the rung stamp, so the rung controller attributes the
                # score without a spec lookup
                result["asha"] = dict(st["asha"])
            if st.get("speculative"):
                result["speculative"] = True
            if device_best_pos == j:
                result["device_argmax"] = True
            if j == 0 and batch_cost is not None:
                # the batch's cost rides exactly one result into the job
                # store, where job_cost sums it
                result["batch_cost"] = batch_cost
            results[gi] = result
            counter_inc("tpuml_subtasks_completed_total")
            if on_result:
                on_result(st["subtask_id"], "completed", result)
            if on_metrics:
                on_metrics(_metrics_message(st, received_at, started_at, finished_at,
                                            model_type, run.trial_metrics[j],
                                            self.executor_id, resources, run=run,
                                            batch_size=len(idxs), primary=(j == 0),
                                            batch_cost=batch_cost))

    def _n_devices(self) -> int:
        from ..parallel.mesh import mesh_info

        return mesh_info(self.mesh)[0]

    @staticmethod
    def _record_batch_cost(run, model_type: str, dataset_id: str, batch_size: int,
                           resources: Optional[Dict[str, Any]] = None,
                           n_devices: int = 1) -> Optional[Dict[str, Any]]:
        """Device cost accounting for one executed batch: the
        ``tpuml_executor_flops_total`` / ``_mfu`` / ``tpuml_device_hbm_bytes``
        families, and the cost record that rides the batch's first result
        (the ``GET /cost/<job_id>`` input). None when ``CS230_OBS=0``. MFU
        only from a complete model-FLOP sum (``flops_coverage`` 1.0), over
        the batch's run window and the peak of each of ``n_devices`` ranks'
        cards (the whole mesh's FLOPs over one card's peak would read N
        times too high); None on the CPU."""
        if not obs_enabled():
            return None
        flops = run.model_flops if run.model_flops is not None else run.xla_flops
        mfu_val = (_mfu(run.model_flops, run.run_time_s, n_devices=n_devices)
                   if run.flops_coverage == 1.0 else None)
        if flops is not None:
            counter_inc("tpuml_executor_flops_total", flops, model=model_type)
        if run.bytes_accessed is not None:
            counter_inc("tpuml_executor_bytes_total", run.bytes_accessed, model=model_type)
        if mfu_val is not None:
            gauge_set("tpuml_executor_mfu", mfu_val, model=model_type)
        record_hbm_gauges()
        # the batch's own peak (the sampler resets the allocator's peak on
        # entry); the run's high-water is the fallback
        dev_peak_mb = (resources or {}).get("device_peak_mem_mb")
        hbm_peak = int(dev_peak_mb * 1e6) if dev_peak_mb is not None else run.hbm_peak_bytes
        return {
            "model_type": model_type,
            "dataset_id": dataset_id,
            "n_subtasks": batch_size,
            "n_devices": int(n_devices),
            "device_seconds": run.run_time_s,
            "model_flops": run.model_flops,
            "xla_flops": run.xla_flops,
            "bytes_accessed": run.bytes_accessed,
            "flops_coverage": run.flops_coverage,
            "mfu": mfu_val,
            "hbm_peak_bytes": hbm_peak,
        }

    @staticmethod
    def _record_batch_phases(batch_sp, run, started_at: float,
                             batch_cost: Optional[Dict[str, Any]] = None) -> None:
        """The engine's measured phase totals as synthesized children of
        the batch span, laid out in sequence from the batch's start (the
        durations are measured, the offsets indicative; attrs carry
        ``synthesized: true``)."""
        if batch_sp is None or getattr(batch_sp, "span_id", None) is None:
            return
        batch_sp.attrs.update(
            n_dispatches=run.n_dispatches,
            n_host_fetches=run.n_host_fetches,
            result_bytes=run.result_bytes,
            compile_time_s=round(run.compile_time_s, 6),
            run_time_s=round(run.run_time_s, 6),
        )
        if batch_cost is not None:
            batch_sp.attrs.update({
                k: batch_cost[k]
                for k in ("model_flops", "xla_flops", "bytes_accessed", "mfu", "hbm_peak_bytes")
                if batch_cost.get(k) is not None})
        t = record_phase(batch_sp, "executor.compile", run.compile_time_s, start=started_at)
        t = record_phase(batch_sp, "executor.stage", run.stage_time_s, start=t)
        dispatch_s = max(run.run_time_s - run.fetch_time_s, 0.0)
        t = record_phase(batch_sp, "executor.dispatch", dispatch_s, start=t,
                         n_dispatches=run.n_dispatches)
        record_phase(batch_sp, "executor.fetch", run.fetch_time_s, start=t,
                     n_host_fetches=run.n_host_fetches, result_bytes=run.result_bytes)

    def _run_trials(self, kernel, data, plan, params, scoring) -> TrialRunResult:
        if callable(scoring) and not isinstance(scoring, str):
            # host-side path: fits on the device per (trial, split), the
            # scikit-learn export, the user's scorer on the host
            t0 = time.perf_counter()
            metrics_list = run_trials_callable(kernel, data, plan, params, scoring,
                                               device=self.device)
            return TrialRunResult(trial_metrics=metrics_list,
                                  run_time_s=time.perf_counter() - t0,
                                  n_dispatches=len(params) * plan.n_splits)
        return run_trials(kernel, data, plan, params, device=self.device,
                          max_trials_per_batch=self.max_trials_per_batch, scoring=scoring,
                          mesh=self.mesh)

    def prewarm_hint(self, hint: Dict[str, Any], mode: str = "construct") -> Dict[str, Any]:
        """Warm one coordinator prewarm hint (JAX ``prewarm_hint``): resolve
        the dataset (a cold agent fetches and parses it), then run the
        hinted job shape's engine call with ``warm_only=True``: the kernel
        libraries are built or loaded and the bucket's tensors staged, and
        nothing is dispatched. ``mode="execute"`` also dispatches the bucket
        once with the hinted parameters and discards the result.

        Hint schema (``Coordinator.prewarm_hints``): ``{model_type,
        dataset_id, parameters, n_trials, train_params}``; ``n_trials`` is
        capped at this executor's ``max_trials_per_batch`` (the largest
        batch a pull delivers). A string ``scoring`` survives into the warm
        (it changes the bucket's path)."""
        kernel = get_kernel(hint["model_type"])
        data = self.cache.get(hint["dataset_id"], kernel.task)
        tp = dict(hint.get("train_params") or {})
        scoring = tp.get("scoring")
        scoring = _normalize_scoring(scoring if isinstance(scoring, str) else None,
                                     kernel.task, data.n_classes, kernel)
        plan = build_split_plan(
            np.asarray(data.y), task=kernel.task, n_folds=_coerce_cv(tp.get("cv")),
            test_size=float(tp.get("test_size", get_config().execution.default_test_size)),
            random_state=tp.get("random_state", 42),
        )
        n_trials = max(1, min(int(hint.get("n_trials") or 1), self.max_trials_per_batch))
        params = dict(hint.get("parameters") or {})
        run = run_trials(kernel, data, plan, [params] * n_trials, device=self.device,
                         max_trials_per_batch=self.max_trials_per_batch, scoring=scoring,
                         mesh=self.mesh, warm_only=(mode != "execute"))
        return {
            "model_type": hint["model_type"],
            "dataset_id": hint["dataset_id"],
            "n_trials": n_trials,
            "mode": mode,
            "compile_s": round(run.compile_time_s, 6),
            "stage_s": round(run.stage_time_s, 6),
            "run_s": round(run.run_time_s, 6),
            "n_dispatches": run.n_dispatches,
        }

    def fit_artifact(self, subtask: Dict[str, Any]) -> Dict[str, Any]:
        """Refit one configuration on the holdout split's training rows and
        return its artifact dict (runtime/artifacts.py). The ``n_folds=0``
        plan's split 0 is the search plan's holdout split (ops/folds.py),
        so these are the rows the winner's holdout score was fitted on."""
        kernel = get_kernel(subtask["model_type"])
        data = self.cache.get(subtask["dataset_id"], kernel.task)
        tp = subtask.get("train_params", {}) or {}
        plan = build_split_plan(
            np.asarray(data.y),
            task=kernel.task,
            n_folds=0,
            test_size=float(tp.get("test_size", get_config().execution.default_test_size)),
            random_state=tp.get("random_state", 42),
        )
        fitted, static = fit_single(kernel, data, plan, subtask["parameters"],
                                    device=self.device)
        return {
            "model_type": subtask["model_type"],
            "parameters": subtask["parameters"],
            "static": dict(static),
            "fitted_params": fitted,
        }


def _metrics_message(st, received_at, started_at, finished_at, algo, metrics,
                     worker_id: str = EXECUTOR_ID,
                     resources: Optional[Dict[str, Optional[float]]] = None, *,
                     run: Optional[TrialRunResult] = None, batch_size: int = 1,
                     primary: bool = False,
                     batch_cost: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The reference's metrics schema (``worker.py:233-243``): timing, the
    batch's resource averages (``ResourceSampler``), and for an
    adaptive-search rung its rung, ``resource``, ``intermediate_score`` and
    ``asha_resource_fraction``; the trial's ``curve`` and ``attempt`` when
    it has one. ``obs_pid`` names the process that already observed the
    batch's phase and cost metrics; with ``run``, the batch's totals as
    ``batch_*`` fields (the same on every message of the batch;
    ``batch_primary`` marks one), and with ``batch_cost`` its cost figures,
    so the coordinator can count a remote agent's batches."""
    msg = {
        "worker_id": worker_id,
        "subtask_id": st["subtask_id"],
        "status": "DONE",
        "received_at": received_at,
        "started_at": started_at,
        "finished_at": finished_at,
        "cpu_percent_avg": None,
        "mem_percent_avg": None,
        "device_peak_mem_mb": None,
        **(resources or {}),
        "algo": algo,
        "obs_pid": process_token(),
    }
    a = st.get("asha")
    if a:
        msg["rung"] = int(a.get("rung", 0))
        msg["resource"] = int(a.get("resource", 0))
        msg["intermediate_score"] = metrics.get("mean_cv_score")
        big = a.get("max_resource")
        if isinstance(big, (int, float)) and big > 0:
            msg["asha_resource_fraction"] = min(
                max(float(a.get("resource", 0)) / float(big), 0.01), 1.0)
    if run is not None:
        msg["batch_n_subtasks"] = batch_size
        msg["batch_n_dispatches"] = run.n_dispatches
        msg["batch_device_fetches"] = run.n_host_fetches
        msg["batch_result_bytes"] = run.result_bytes
        msg["batch_primary"] = bool(primary)
        msg["batch_compile_s"] = run.compile_time_s
        msg["batch_stage_s"] = run.stage_time_s
        msg["batch_dispatch_s"] = run.run_time_s
        msg["batch_fetch_s"] = run.fetch_time_s
    if batch_cost is not None:
        msg["batch_model_flops"] = batch_cost.get("model_flops")
        msg["batch_xla_flops"] = batch_cost.get("xla_flops")
        msg["batch_bytes_accessed"] = batch_cost.get("bytes_accessed")
        msg["batch_mfu"] = batch_cost.get("mfu")
        msg["batch_hbm_peak_bytes"] = batch_cost.get("hbm_peak_bytes")
    if metrics.get("curve") is not None:
        msg["curve"] = metrics["curve"]
        msg["attempt"] = int(st.get("attempt") or 0)
    return msg


def _normalize_scoring(scoring, task: str, n_classes: int = 0, kernel=None):
    """Validate a job's ``scoring`` and collapse the task's default scorer
    to None (the engine's default metric). A transform takes no scorer;
    an unknown name, a binary-only scorer on a multiclass target or a
    scorer the kernel has no output for fails the batch with the reason."""
    from ..ops.metrics import validate_scoring

    if scoring is None:
        return None
    if task != "transform" and scoring == ("accuracy" if task == "classification" else "r2"):
        return None
    validate_scoring(scoring, task, n_classes, kernel)
    return scoring


def _coerce_cv(cv) -> int:
    """Accept the cv forms sklearn search wrappers take: None (default 5),
    an int, or a CV splitter object (its fold count)."""
    if cv is None:
        return get_config().execution.default_cv_folds
    if isinstance(cv, (int, float)):
        return int(cv)
    if hasattr(cv, "get_n_splits"):
        return int(cv.get_n_splits())
    try:
        return int(cv)
    except (TypeError, ValueError):
        return get_config().execution.default_cv_folds
