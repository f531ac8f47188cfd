"""Coordinator: sessions, job fan-out, result collection, aggregation.

Port of the direct mode of the JAX package's ``runtime/coordinator.py``:
one process owns the job store and one in-process executor on the card.
The job lifecycle mirrors the reference: create a session, stage and
preprocess datasets, expand a train job into per-trial subtasks, run
them, aggregate by ``mean_cv_score`` (best first, ties to the earlier
trial), and refit the winner for its artifact on demand
(``best_model_path``).

An adaptive-search job (``asha`` / ``hyperband``, runtime/search.py) runs
as synchronous rung waves on the in-process executor: each wave's
reports feed the rung controller in the group's order, and its Steps
give the next wave. Learning curves of every result and metrics message
land in the CurveStore (``job_curves`` / ``subtask_curves`` and the
``curve`` events of ``stream_status``); on the metrics path of a search,
the numerical-health watchdog terminates a diverging trial as
``diverged``.
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
from ..obs import counter_inc, flush_journal, record_event
from ..obs.curves import CurveStore, divergence
from ..parallel.collectives import best_trial
from ..utils.config import FrameworkConfig, get_config
from ..utils.logging import get_logger
from ..utils.torch_setup import DeviceLike, resolve_device
from .artifacts import save_artifact
from .executor import LocalExecutor
from .search import SearchJobDriver, Step
from .store import TERMINAL_STATUSES, JobStore
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
        # per-trial learning curves, fed by result and metrics ingest; the
        # journaled curves of a read-back journal re-seed it
        self.curves = CurveStore()
        for e in self.store.drain_replayed_curves():
            self.curves.ingest(e["jid"], e["stid"], e["curve"], rung=e["rung"],
                               attempt=e["attempt"], diverged=e["diverged"])

    def create_session(self, session_id: Optional[str] = None, *, priority: int = 0) -> str:
        """``priority`` is the session's QoS lane, kept in the session
        record and its journal line (JAX ``create_session``)."""
        return self.store.create_session(session_id, priority=priority)

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
        """Execute a job's subtasks and aggregate; any error fails the job.
        A job whose specs carry an ``asha`` block goes through the rung
        controller (``_run_job_search_direct``)."""

        def on_result(subtask_id: str, status: str, result: Optional[Dict[str, Any]]):
            self.store.update_subtask(sid, job_id, subtask_id, status, result)
            r = result or {}
            if isinstance(r.get("curve"), dict):
                # verdict only: this result is terminal already
                self.ingest_curve(sid, job_id, subtask_id, r["curve"],
                                  rung=int((r.get("asha") or {}).get("rung") or 0),
                                  attempt=int(r.get("attempt") or 0))
            record_event("result", job_id=job_id, subtask_id=subtask_id,
                         attempt=int(r.get("attempt") or 0), status=status,
                         mean_cv_score=r.get("mean_cv_score"), error=r.get("error"))

        def on_metrics(msg: Dict[str, Any]):
            if isinstance(msg.get("curve"), dict):
                # live ingest at the group boundary, before the result settles
                self.ingest_curve(sid, job_id, msg.get("subtask_id"), msg["curve"],
                                  rung=int(msg.get("rung") or 0),
                                  attempt=int(msg.get("attempt") or 0))

        def on_intermediate(subtask_id: str, result: Optional[Dict[str, Any]]):
            # a non-terminal rung boundary (promoted or paused): journal the
            # report and its curve, no terminal transition
            self.store.update_subtask(sid, job_id, subtask_id, "promoted", result)
            r = result or {}
            if isinstance(r.get("curve"), dict):
                self.ingest_curve(sid, job_id, subtask_id, r["curve"],
                                  rung=int((r.get("asha") or {}).get("rung") or 0),
                                  attempt=int(r.get("attempt") or 0))
            record_event("result", job_id=job_id, subtask_id=subtask_id,
                         attempt=int(r.get("attempt") or 0), status="promoted",
                         mean_cv_score=r.get("mean_cv_score"),
                         rung=(r.get("asha") or {}).get("rung"))

        driver: Optional[SearchJobDriver] = None
        if any(st.get("asha") for st in subtasks):
            driver = SearchJobDriver(subtasks)
            # rebuild rung state from the journaled rung history (a no-op on
            # a fresh job; resuming an in-flight job waits for ROADMAP A2)
            driver.resume(self.store.get_job(sid, job_id))
        try:
            if driver is not None:
                by_id = self._run_job_search_direct(sid, job_id, driver, on_result,
                                                    on_intermediate, on_metrics)
                results = [by_id.get(st["subtask_id"]) for st in subtasks]
            else:
                results = self.executor.run_subtasks(subtasks, on_result=on_result,
                                                     on_metrics=on_metrics)
            self._aggregate(sid, job_id, results, subtasks,
                            search_summary=driver.summary() if driver is not None else None)
            counter_inc("tpuml_jobs_completed_total")
        except Exception as e:  # noqa: BLE001 — the job thread's boundary
            logger.exception("Job %s failed", job_id)
            counter_inc("tpuml_jobs_failed_total")
            flush_journal()
            self.store.finalize_job(sid, job_id, {"status": "failed", "error": str(e)})

    def _apply_search_step_direct(self, step: Step, results_by_id, on_result,
                                  on_intermediate) -> List[Dict[str, Any]]:
        """Apply one Step; returns the fresh rung dispatches for the next
        wave."""
        for tid, res in step.promoted:
            if res is not None:
                on_intermediate(tid, res)
        new_tasks = []
        for task in step.new_tasks:
            # no attempt ledger in direct mode: bump the attempt stamp so rung
            # dispatches stay distinguishable in results and journals
            task["attempt"] = int(task.get("attempt") or 0) + 1
            task.pop("speculative", None)
            new_tasks.append(task)
        if step.cancels:
            self.executor.cancel(step.cancels)
        for tid, status, res in step.finished:
            results_by_id[tid] = res
            on_result(tid, status, res)
        return new_tasks

    def _run_job_search_direct(self, sid, job_id, driver: SearchJobDriver, on_result,
                               on_intermediate, on_metrics) -> Dict[str, Dict[str, Any]]:
        """The rung loop: synchronous waves on the in-process executor. The
        executor's metrics messages carry each rung's score and curve;
        during a wave they feed the watchdog and the stop_score fast path,
        so cancels reach the executor before its next group boundary.
        After the wave, each result feeds the controller in the wave's
        order. Failures are terminal (no retries) and drop the trial off
        its ladder."""
        results_by_id: Dict[str, Dict[str, Any]] = {}
        self._apply_search_step_direct(driver.resume_step(), results_by_id, on_result,
                                       on_intermediate)
        tasks = driver.pending_tasks()
        while tasks:
            steps: List[Step] = []

            def _metrics(msg):
                curve = msg.get("curve")
                stid_m = msg.get("subtask_id")
                if isinstance(curve, dict) and stid_m:
                    # the watchdog on the metrics path: a diverged trial ends
                    # now instead of burning the rest of its rung budget
                    if self.ingest_curve(sid, job_id, stid_m, curve,
                                         rung=int(msg.get("rung") or 0),
                                         attempt=int(msg.get("attempt") or 0)):
                        dstep = driver.handle_diverged(stid_m, curve, result=None)
                        if dstep.cancels:
                            self.executor.cancel(dstep.cancels)
                        if dstep.finished or dstep.new_tasks or dstep.promoted:
                            steps.append(dstep)
                step = driver.handle_metrics(msg)
                if step.cancels:
                    self.executor.cancel(step.cancels)
                if step.finished or step.new_tasks or step.promoted:
                    steps.append(step)
                on_metrics(msg)

            wave = self.executor.run_subtasks(tasks, on_metrics=_metrics)
            for st, r in zip(tasks, wave):
                stid = st["subtask_id"]
                r = r or {}
                status = r.get("status", "completed")
                if status == "failed":
                    steps.append(driver.handle_quarantine(stid, r))
                elif status == "pruned":
                    steps.append(driver.handle_pruned_result(stid, r))
                else:
                    steps.append(driver.handle_result(stid, r))
            tasks = []
            for step in steps:
                tasks.extend(self._apply_search_step_direct(step, results_by_id, on_result,
                                                            on_intermediate))
            self.store.set_search_state(sid, job_id, driver.summary())
        if not driver.done():
            logger.warning("Search job %s: wave loop drained with %d trials undecided",
                           job_id, sum(1 for t in driver.specs
                                       if t not in driver.controller.decided))
        return results_by_id

    def _aggregate(self, sid, job_id, results, subtasks,
                   search_summary: Optional[Dict[str, Any]] = None) -> None:
        """Completed trials sorted by mean_cv_score, best first; the
        winner is the first trial with the highest score. The winner's
        subtask spec is kept for its artifact, which is refitted lazily, on
        the first ``best_model_path`` (the reference pickled every trial's
        model, ``worker.py:352-356``: pure overhead for a search). An
        adaptive-search winner is refitted at its final rung's parameters.
        Pruned and diverged trials are separate, non-failure reports."""
        completed = [r for r in results if r and r.get("status") == "completed"]
        failed = [r for r in results if r and r.get("status") == "failed"]
        pruned = [r for r in results if r and r.get("status") == "pruned"]
        diverged = [r for r in results if r and r.get("status") == "diverged"]

        def score_key(r):
            v = r.get("mean_cv_score")
            return v if isinstance(v, (int, float)) else float("-inf")

        best = None
        if completed:
            idx, _ = best_trial([score_key(r) for r in completed])
            best = dict(completed[idx])
            st = next(s for s in subtasks if s["subtask_id"] == best["subtask_id"])
            if best.get("asha") and best.get("parameters"):
                # the subtask list still holds the rung-0 spec
                st = {**st, "parameters": best["parameters"]}
            with self._artifact_lock:
                self._artifact_specs[(sid, job_id)] = st
        final = {
            "results": sorted(completed, key=score_key, reverse=True),
            "failed": failed,
            "best_result": best,
            "completion_time": time.time(),
        }
        if pruned or search_summary is not None:
            final["pruned_results"] = sorted(pruned, key=score_key, reverse=True)
            final["n_pruned"] = len(pruned)
            if search_summary is not None:
                final["search"] = search_summary
        if diverged:
            final["diverged_results"] = diverged
            final["n_diverged"] = len(diverged)
        flush_journal()  # the job's events are on disk once it reads as done
        self.store.finalize_job(sid, job_id, final)

    # ------------- learning curves -------------

    def ingest_curve(self, sid: str, job_id: str, subtask_id: str, curve: Dict[str, Any],
                     *, rung: int = 0, attempt: int = 0) -> bool:
        """Ingest one trial's curve record and return the watchdog's
        divergence verdict. The store dedups on (subtask, rung, attempt),
        so a curve delivered by both the metrics and the result transport
        counts, journals and records its event once; the caller decides
        whether the verdict ends the trial (search loops do)."""
        if not isinstance(curve, dict) or not subtask_id:
            return False
        diverged = divergence(curve, self.config.service.curve_divergence_factor)
        added = self.curves.ingest(job_id, subtask_id, curve, rung=rung, attempt=attempt,
                                   diverged=diverged)
        if added:
            counter_inc("tpuml_curve_points_total", float(added))
            record_event("curve.ingest", job_id=job_id, subtask_id=subtask_id,
                         rung=int(rung or 0), attempt=int(attempt or 0), n_points=added,
                         diverged=diverged)
            try:
                self.store.record_curve(sid, job_id, subtask_id, curve, rung=rung,
                                        attempt=attempt, diverged=diverged)
            except KeyError:
                pass  # an unknown job: serve from memory only
        return diverged

    def job_curves(self, job_id: str) -> Optional[Dict[str, Any]]:
        """Every recorded curve of a job, joined with its live status; None
        when the job id is unknown, an empty ``curves`` list when it has
        none yet."""
        sid = self.store.session_of(job_id)
        if sid is None:
            return None
        progress = self.store.job_progress(sid, job_id)
        out = self.curves.job(job_id) or {"job_id": job_id, "n_curves": 0, "curves": []}
        out["job_status"] = progress.get("job_status")
        out["tasks_diverged"] = progress.get("tasks_diverged", 0)
        return out

    def subtask_curves(self, job_id: str, subtask_id: str) -> Dict[str, Any]:
        """One trial's curves across rungs and attempts; KeyError when the
        pair never reported one."""
        out = self.curves.subtask(job_id, subtask_id)
        if out is None:
            raise KeyError(f"no curves recorded for subtask {subtask_id!r} of job {job_id!r}")
        return out

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

    def stream_status(self, sid: str, job_id: str, tick_s: Optional[float] = None):
        """Generator of progress snapshots until the job ends, with the
        freshly ingested curves interleaved as ``{"kind": "curve", ...}``
        events (the CurveStore's version is the cursor, so each curve
        streams once). The snapshot is read before the curve drain: a
        terminal status means aggregation finished, so every curve is
        already behind the cursor and flushes before the last snapshot."""
        tick = tick_s if tick_s is not None else self.config.service.sse_tick_s
        since = 0
        while True:
            progress = self.store.job_progress(sid, job_id)
            fresh, since = self.curves.updates(job_id, since)
            for entry in fresh:
                yield {"kind": "curve", "job_id": job_id, **entry}
            yield progress
            if progress["job_status"] in TERMINAL_STATUSES:
                return
            time.sleep(tick)

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
