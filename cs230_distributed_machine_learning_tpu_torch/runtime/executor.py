"""Trial executor: runs subtask batches on the local device.

Port of ``LocalExecutor.run_subtasks`` / ``_run_group`` of the JAX
package's ``runtime/executor.py``: subtasks are grouped by (dataset,
model type) and each group runs as one call of the trial engine
(parallel/trial_map.py). Per-subtask results keep the reference's schema.
A group that raises (unknown or not-yet-ported model, missing dataset,
unsupported scoring) fails its subtasks with the error text; the job goes
on. ``fit_artifact`` refits a job's winner for its artifact.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import DatasetCache
from ..models.registry import get_kernel
from ..ops.folds import build_split_plan
from ..parallel.trial_map import fit_single, run_trials
from ..utils.config import get_config
from ..utils.logging import get_logger

logger = get_logger("tpuml.executor")

ResultCallback = Callable[[str, str, Optional[Dict[str, Any]]], None]


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

    def run_subtasks(
        self,
        subtasks: List[Dict[str, Any]],
        *,
        on_result: Optional[ResultCallback] = None,
    ) -> List[Dict[str, Any]]:
        """Run subtasks grouped by (dataset, model_type); returns results in
        input order. ``on_result`` fires per subtask as groups complete."""
        results: List[Optional[Dict[str, Any]]] = [None] * len(subtasks)
        groups: Dict[Any, List[int]] = {}
        for i, st in enumerate(subtasks):
            groups.setdefault((st["dataset_id"], st["model_type"]), []).append(i)

        for (dataset_id, model_type), idxs in groups.items():
            try:
                self._run_group(subtasks, idxs, dataset_id, model_type, results, on_result)
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
                    if on_result:
                        on_result(st["subtask_id"], "failed", result)
        return results  # type: ignore[return-value]

    def _run_group(self, subtasks, idxs, dataset_id, model_type, results, on_result) -> None:
        kernel = get_kernel(model_type)
        data = self.cache.get(dataset_id, kernel.task)
        tp = subtasks[idxs[0]].get("train_params", {}) or {}
        plan = build_split_plan(
            np.asarray(data.y),
            task=kernel.task,
            n_folds=_coerce_cv(tp.get("cv")),
            test_size=float(tp.get("test_size", get_config().execution.default_test_size)),
            random_state=tp.get("random_state", 42),
        )
        run = run_trials(
            kernel,
            data,
            plan,
            [subtasks[i]["parameters"] for i in idxs],
            device=self.device,
            max_trials_per_batch=self.max_trials_per_batch,
            scoring=_normalize_scoring(tp.get("scoring"), kernel.task, data.n_classes, kernel),
        )
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
            results[gi] = result
            if on_result:
                on_result(st["subtask_id"], "completed", result)


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
