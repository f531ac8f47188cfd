"""Coordinator: sessions, job fan-out, result collection, aggregation.

Port of the direct mode of the JAX package's ``runtime/coordinator.py``:
one process owns the job store and one in-process executor on the card.
The job lifecycle mirrors the reference: create a session, stage and
preprocess datasets, expand a train job into per-trial subtasks, run
them, aggregate by ``mean_cv_score`` (best first, ties to the earlier
trial), and refit the winner for its artifact on demand
(``best_model_path``).
"""

from __future__ import annotations

import glob
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..data.datasets import DatasetCache, dataset_dir, find_csv
from ..data.download import download_dataset
from ..data.preprocess import preprocess_dataframe
from ..parallel.collectives import best_trial
from ..utils.config import FrameworkConfig, get_config
from ..utils.logging import get_logger
from ..utils.torch_setup import DeviceLike, resolve_device
from .artifacts import save_artifact
from .executor import LocalExecutor
from .store import JobStore
from .subtasks import create_subtasks

logger = get_logger("tpuml.coordinator")


class Coordinator:
    def __init__(
        self,
        config: Optional[FrameworkConfig] = None,
        *,
        device: DeviceLike = None,
        executor: Optional[LocalExecutor] = None,
        journal: bool = False,
    ):
        """``device`` defaults to the CUDA card and raises when there is
        none; ``device="cpu"`` runs on the host. ``journal=True`` keeps the
        job store's JSONL journal under the storage root and reads back the
        jobs of an earlier run (finished ones; in-flight jobs are not
        resumed)."""
        self.config = config or get_config()
        self.device = resolve_device(device)
        self.store = JobStore(journal_dir=self.config.storage.journal_dir if journal else None)
        self.cache = DatasetCache(root=self.config.storage.datasets_dir)
        self.executor = executor or LocalExecutor(self.device, cache=self.cache)
        self._job_threads: Dict[str, threading.Thread] = {}
        # the winner's subtask spec of each finished job, and its artifact's
        # path once refitted (best_model_path)
        self._artifact_lock = threading.Lock()
        self._artifact_specs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._artifact_paths: Dict[Tuple[str, str], str] = {}

    def create_session(self, session_id: Optional[str] = None) -> str:
        return self.store.create_session(session_id)

    # ------------- data -------------

    def download_data(self, sid: str, dataset_url: str, dataset_name: str,
                      dataset_type: str) -> Dict[str, Any]:
        """Stage a dataset (kaggle, huggingface, local or builtin)."""
        self._require_session(sid)
        path = download_dataset(dataset_url, dataset_name, dataset_type,
                                root=self.config.storage.datasets_dir)
        self.cache.invalidate(dataset_name)
        return {"status": "success", "dataset_path": path}

    def check_data(self, sid: str, dataset_name: str) -> Dict[str, Any]:
        self._require_session(sid)
        path = find_csv(dataset_name, root=self.config.storage.datasets_dir)
        return {"exists": path is not None, "path": path}

    def preprocess(self, sid: str, dataset_id: str,
                   config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run the preprocessing pipeline on a staged raw dataset and stage
        the result as its preprocessed CSV. ``config`` is the pipeline's
        dict; None reads ``<configs_dir>/<dataset_id>/*.yaml`` (needs
        PyYAML)."""
        self._require_session(sid)
        import pandas as pd

        csv = find_csv(dataset_id, root=self.config.storage.datasets_dir)
        if csv is None:
            raise FileNotFoundError(f"Dataset {dataset_id!r} not staged")
        if config is None:
            import yaml

            hits = sorted(glob.glob(
                os.path.join(self.config.storage.configs_dir, dataset_id, "*.yaml")))
            if not hits:
                raise FileNotFoundError(f"No preprocess config for {dataset_id!r}")
            with open(hits[0]) as f:
                config = yaml.safe_load(f.read())
        df = preprocess_dataframe(pd.read_csv(csv), config)
        out_dir = os.path.join(dataset_dir(dataset_id, self.config.storage.datasets_dir),
                               "preprocessed")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{dataset_id}_preprocessed.csv")
        df.to_csv(out_path, index=False)
        self.cache.invalidate(dataset_id)
        return {"status": "success", "preprocessed_path": out_path, "n_rows": len(df)}

    # ------------- training -------------

    def submit_train(self, sid: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Expand a train job into subtasks, persist, and run it on a
        background thread. Payload: {job_id?, dataset_id, model_details,
        train_params}."""
        self._require_session(sid)
        job_id = payload.get("job_id") or str(uuid.uuid4())
        if self.store.has_job(sid, job_id):
            # idempotent resubmit of a client-minted job id
            return {
                "status": "submitted",
                "job_id": job_id,
                "total_subtasks": self.store.job_progress(sid, job_id)["total_subtasks"],
                "duplicate": True,
            }
        dataset_id = payload["dataset_id"]
        model_details = payload["model_details"]
        train_params = dict(payload.get("train_params") or {})
        cv_params = model_details.get("cv_params") or {}
        if "cv" in cv_params and "cv" not in train_params:
            train_params["cv"] = cv_params["cv"]
        subtasks = create_subtasks(job_id, sid, dataset_id, model_details, train_params)
        try:
            metadata = self.cache.metadata(dataset_id)
        except FileNotFoundError:
            metadata = {}
        self.store.create_job(sid, job_id, payload, subtasks, metadata)
        t = threading.Thread(target=self._run_job, args=(sid, job_id, subtasks), daemon=True)
        self._job_threads[job_id] = t
        t.start()
        return {"status": "submitted", "job_id": job_id, "total_subtasks": len(subtasks)}

    def _run_job(self, sid: str, job_id: str, subtasks: List[Dict[str, Any]]) -> None:
        """Execute a job's subtasks and aggregate; any error fails the job."""

        def on_result(subtask_id: str, status: str, result: Optional[Dict[str, Any]]):
            self.store.update_subtask(sid, job_id, subtask_id, status, result)

        try:
            results = self.executor.run_subtasks(subtasks, on_result=on_result)
            self._aggregate(sid, job_id, results, subtasks)
        except Exception as e:  # noqa: BLE001 — the job thread's boundary
            logger.exception("Job %s failed", job_id)
            self.store.finalize_job(sid, job_id, {"status": "failed", "error": str(e)})

    def _aggregate(self, sid, job_id, results, subtasks) -> None:
        """Completed trials sorted by mean_cv_score, best first; the
        winner is the first trial with the highest score. The winner's
        subtask spec is kept for its artifact, which is refitted lazily, on
        the first ``best_model_path`` (the reference pickled every trial's
        model, ``worker.py:352-356``: pure overhead for a search)."""
        completed = [r for r in results if r and r.get("status") == "completed"]
        failed = [r for r in results if r and r.get("status") == "failed"]

        def score_key(r):
            v = r.get("mean_cv_score")
            return v if isinstance(v, (int, float)) else float("-inf")

        best = None
        if completed:
            idx, _ = best_trial([score_key(r) for r in completed])
            best = dict(completed[idx])
            st = next(s for s in subtasks if s["subtask_id"] == best["subtask_id"])
            with self._artifact_lock:
                self._artifact_specs[(sid, job_id)] = st
        final = {
            "results": sorted(completed, key=score_key, reverse=True),
            "failed": failed,
            "best_result": best,
            "completion_time": time.time(),
        }
        self.store.finalize_job(sid, job_id, final)

    # ------------- status / metrics -------------

    def check_status(self, sid: str, job_id: str) -> Dict[str, Any]:
        self._require_session(sid)
        progress = self.store.job_progress(sid, job_id)
        if progress["job_status"] == "completed" and progress["job_result"]:
            result = progress["job_result"]
            out = {"job_status": "completed", "job_result": result}
            if result.get("results") and len(result["results"]) > 1:
                out["best_result"] = result.get("best_result")
            return out
        return progress

    def job_metrics(self, sid: str, job_id: str) -> List[Dict[str, Any]]:
        """Per-subtask results array."""
        self._require_session(sid)
        return self.store.subtask_results(sid, job_id)

    def wait_for_completion(self, sid: str, job_id: str,
                            timeout_s: Optional[float] = None) -> Dict[str, Any]:
        timeout = timeout_s or self.config.service.client_timeout_s
        if not self.store.wait_job(sid, job_id, timeout):
            raise TimeoutError(f"Job {job_id} did not complete in time")
        return self.store.job_progress(sid, job_id)

    def best_model_path(self, sid: str, job_id: str) -> Optional[str]:
        """Path of the job's winner artifact: refitted on the device on the
        first call (runtime/executor.py::fit_artifact), the cached path
        after. None where the job has no winner spec (no completed trial,
        or a job read back from the journal)."""
        self._require_session(sid)
        with self._artifact_lock:
            path = self._artifact_paths.get((sid, job_id))
            if path is not None:
                return path
            st = self._artifact_specs.get((sid, job_id))
        if st is None:
            return None
        artifact = self.executor.fit_artifact(st)
        path = save_artifact(st["subtask_id"], artifact, self.config.storage.models_dir)
        with self._artifact_lock:
            self._artifact_paths[(sid, job_id)] = path
        return path

    def _require_session(self, sid: str) -> None:
        if not self.store.has_session(sid):
            raise KeyError(f"Invalid session id: {sid}")
