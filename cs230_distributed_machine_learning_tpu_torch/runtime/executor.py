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
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import DatasetCache
from ..models.registry import get_kernel
from ..obs import counter_inc
from ..ops.folds import build_split_plan
from ..parallel.trial_map import TrialRunResult, fit_single, run_trials, run_trials_callable
from ..utils.config import get_config
from ..utils.logging import get_logger

logger = get_logger("tpuml.executor")

ResultCallback = Callable[[str, str, Optional[Dict[str, Any]]], None]
MetricsCallback = Callable[[Dict[str, Any]], None]

#: the executor id of the in-process executor, on its metrics messages
EXECUTOR_ID = "local"


class LocalExecutor:
    """Executes trial batches on ``device``."""

    def __init__(
        self,
        device: torch.device,
        *,
        cache: Optional[DatasetCache] = None,
        max_trials_per_batch: Optional[int] = None,
    ):
        self.device = device
        self.cache = cache or DatasetCache()
        self.max_trials_per_batch = (
            max_trials_per_batch or get_config().execution.max_trials_per_batch
        )
        #: cooperative-cancel set (docs/SEARCH.md): subtask_id -> highest
        #: cancelled attempt, consumed at the next group boundary
        self._cancel_lock = threading.Lock()
        self._cancelled: Dict[str, int] = {}

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
            on_metrics({"worker_id": EXECUTOR_ID, "subtask_id": st["subtask_id"],
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
            try:
                self._run_group(subtasks, idxs, dataset_id, model_type, results,
                                on_result, on_metrics)
            except Exception as e:  # noqa: BLE001 — task-level failure semantics
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
                    results[gi] = result
                    counter_inc("tpuml_subtasks_failed_total")
                    if on_result:
                        on_result(st["subtask_id"], "failed", result)
        return results  # type: ignore[return-value]

    def _run_group(self, subtasks, idxs, dataset_id, model_type, results, on_result,
                   on_metrics=None) -> None:
        received_at = time.time()
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
        started_at = time.time()
        params = [subtasks[i]["parameters"] for i in idxs]
        if callable(scoring) and not isinstance(scoring, str):
            # host-side path: fits on the device per (trial, split), the
            # scikit-learn export, the user's scorer on the host
            t0 = time.perf_counter()
            metrics_list = run_trials_callable(kernel, data, plan, params, scoring,
                                               device=self.device)
            run = TrialRunResult(trial_metrics=metrics_list,
                                 run_time_s=time.perf_counter() - t0)
        else:
            run = run_trials(
                kernel,
                data,
                plan,
                params,
                device=self.device,
                max_trials_per_batch=self.max_trials_per_batch,
                scoring=scoring,
            )
        finished_at = time.time()
        per_trial_time = run.run_time_s / max(len(idxs), 1)
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
            results[gi] = result
            counter_inc("tpuml_subtasks_completed_total")
            if on_result:
                on_result(st["subtask_id"], "completed", result)
            if on_metrics:
                on_metrics(_metrics_message(st, received_at, started_at, finished_at,
                                            model_type, run.trial_metrics[j]))

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


def _metrics_message(st, received_at, started_at, finished_at, algo,
                     metrics) -> Dict[str, Any]:
    """The reference's metrics schema (``worker.py:233-243``) with the
    fields this port can fill: timing; for an adaptive-search rung its
    rung, ``resource``, ``intermediate_score`` and
    ``asha_resource_fraction``; the trial's ``curve`` and ``attempt`` when
    it has one. The host and device resource averages of the JAX
    package's ResourceSampler are ``None`` until the scheduled runtime is
    ported (ROADMAP A2)."""
    msg = {
        "worker_id": EXECUTOR_ID,
        "subtask_id": st["subtask_id"],
        "status": "DONE",
        "received_at": received_at,
        "started_at": started_at,
        "finished_at": finished_at,
        "cpu_percent_avg": None,
        "mem_percent_avg": None,
        "device_peak_mem_mb": None,
        "algo": algo,
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
