"""MLTaskManager: the user-facing client API, local mode.

Port of the local mode of the JAX package's ``client/manager.py``: the
manager talks directly to an in-process Coordinator. ``download_data``,
``check_data`` and ``preprocess`` stage a dataset; ``train`` accepts a
live sklearn estimator, a GridSearchCV / RandomizedSearchCV wrapper, or the
``model_details`` payload they stand for (client/introspection.py; the
form to use where scikit-learn is not installed), plus ``train_params``,
and optionally blocks until the job ends, following the job's event
stream with ``stream=True``; ``search_params`` makes it an adaptive
search (ASHA / Hyperband); ``check_status`` / ``check_job_status`` /
``best_result`` / ``curves`` read results and learning curves;
``download_best_model`` / ``load_best_model`` refit the winner once and
serve its artifact (runtime/artifacts.py).

The constructor takes the JAX package's ``(url, coordinator, priority)``;
remote mode (``url=``) is not ported yet and raises. The work runs on the
CUDA card by default; ``device="cpu"`` runs it on the host. Without a card
and without ``device="cpu"``, construction raises.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional

from ..runtime.store import TERMINAL_STATUSES
from ..utils.config import get_config
from ..utils.torch_setup import DeviceLike
from .introspection import extract_model_details


class MLTaskManager:
    def __init__(self, url: Optional[str] = None, coordinator=None, priority: int = 0, *,
                 device: DeviceLike = None):
        """``priority`` is this session's QoS lane, journaled with the
        session as in the JAX package."""
        if url is not None:
            raise ValueError("remote mode (url=...) is not yet ported to the PyTorch package")
        self.priority = int(priority)
        if coordinator is None:
            from ..runtime.coordinator import Coordinator

            coordinator = Coordinator(device=device)
        self._coordinator = coordinator
        self.session_id = coordinator.create_session(priority=self.priority)
        self.job_id: Optional[str] = None
        self.result: Optional[Dict[str, Any]] = None

    @property
    def device(self):
        return self._coordinator.device

    # ------------- data management -------------

    def check_data(self, data_name: str) -> Dict[str, Any]:
        return self._coordinator.check_data(self.session_id, data_name)

    def download_data(self, data_link: str, data_name: str, data_type: str) -> Dict[str, Any]:
        return self._coordinator.download_data(self.session_id, data_link, data_name, data_type)

    def preprocess(self, dataset_id: str,
                   config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Preprocess a staged dataset with a config dict, or with the
        YAML under the configs directory when ``config`` is None."""
        return self._coordinator.preprocess(self.session_id, dataset_id, config)

    def train(
        self,
        estimator: Any,
        dataset_id: Optional[str] = None,
        train_params: Optional[Dict[str, Any]] = None,
        wait_for_completion: bool = True,
        timeout: Optional[float] = None,
        show_progress: bool = True,
        *,
        dataset_name: Optional[str] = None,
        stream: bool = False,
        search_params: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Submit a training / hyperparameter-search job.

        The signature is the JAX package's, in its order.
        estimator: a sklearn estimator or search wrapper, or a
        ``model_details`` dict ({model_type, search_type,
        base_estimator_params, param_grid | param_distributions + n_iter +
        random_state, cv_params}).
        train_params: {test_size=0.2, random_state=42, cv=5}.
        ``show_progress`` draws a progress bar (tqdm, where installed)
        while ``stream=True`` follows the job; the blocking wait draws none
        (the JAX package's local wait with it off).
        ``dataset_name=`` is accepted as an alias for ``dataset_id``.

        ``search_params=`` makes the job an adaptive search (docs/SEARCH.md):
        ``{"type": "asha" | "hyperband", "eta": 3, "min_resource": r,
        "max_resource": R, "n_iter": n, "stop_score": s, "max_brackets":
        b}``. The estimator's grid or distributions supply the trial
        configurations; the rung controller owns the resource parameter
        (max_iter / n_estimators) and stops doomed trials early as
        ``pruned``.

        ``stream=True`` (with ``wait_for_completion``) follows the job by
        consuming the coordinator's ``stream_status`` generator; the last
        event carries ``job_result``.
        """
        if dataset_name is not None:
            if dataset_id is not None and dataset_id != dataset_name:
                raise TypeError(
                    f"conflicting dataset_id={dataset_id!r} and "
                    f"dataset_name={dataset_name!r} — pass one"
                )
            dataset_id = dataset_name
        if dataset_id is None:
            raise TypeError("train() requires a dataset id (dataset_id= or dataset_name=)")
        model_details = extract_model_details(estimator)
        if search_params:
            sp = dict(search_params)
            stype = sp.pop("type", "asha")
            if stype not in ("asha", "hyperband"):
                raise ValueError(
                    f"search_params['type'] must be 'asha' or 'hyperband', got {stype!r}")
            model_details["search_type"] = stype
            for key in ("n_iter", "random_state"):
                if key in sp:
                    model_details[key] = sp.pop(key)
            model_details["asha"] = sp
        train_params = dict(train_params or {})
        train_params.setdefault("test_size", get_config().execution.default_test_size)
        self.job_id = str(uuid.uuid4())
        payload = {
            "job_id": self.job_id,
            "session_id": self.session_id,
            "dataset_id": dataset_id,
            "model_details": model_details,
            "train_params": train_params,
            "timestamp": time.time(),
        }
        submit = self._coordinator.submit_train(self.session_id, payload)
        self.job_id = submit.get("job_id") or self.job_id
        if not wait_for_completion:
            return submit
        if stream:
            return self._stream_local(timeout=timeout, show_progress=show_progress)
        self._coordinator.wait_for_completion(self.session_id, self.job_id, timeout)
        status = self.check_status()
        if status.get("job_status") in TERMINAL_STATUSES:
            self.result = status.get("job_result")
        return status

    # ------------- the event stream (stream=True) -------------

    @staticmethod
    def _progress_bar(show_progress: bool):
        if not show_progress:
            return None
        try:
            from tqdm import tqdm

            # disable=None: off when stderr is not a tty
            return tqdm(total=100, desc="job", unit="%", disable=None)
        except ImportError:
            return None

    def _finish_stream(self, last: Optional[Dict[str, Any]], timeout: float):
        if last is None or last.get("job_status") not in TERMINAL_STATUSES:
            raise TimeoutError(
                f"Job {self.job_id} stream ended without completion (timeout {timeout}s)")
        self.result = last.get("job_result")
        return last

    def _stream_local(self, timeout: Optional[float] = None,
                      show_progress: bool = True) -> Dict[str, Any]:
        """Iterate the coordinator's ``stream_status`` generator to the
        job's end; curve events are skipped (``curves()`` reads them)."""
        timeout = timeout or get_config().service.client_timeout_s
        deadline = time.time() + timeout
        bar = self._progress_bar(show_progress)
        last: Optional[Dict[str, Any]] = None
        try:
            for progress in self._coordinator.stream_status(self.session_id, self.job_id):
                if progress.get("kind") == "curve":
                    continue
                last = progress
                if bar is not None:
                    bar.n = int(_pct(progress.get("job_status")))
                    _bar_postfix(bar, progress)
                    bar.refresh()
                if progress.get("job_status") in TERMINAL_STATUSES:
                    break
                if time.time() > deadline:
                    raise TimeoutError(f"Job {self.job_id} did not complete within {timeout}s")
        finally:
            if bar is not None:
                bar.close()
        return self._finish_stream(last, timeout)

    def check_status(self, job_id: Optional[str] = None) -> Dict[str, Any]:
        return self._coordinator.check_status(self.session_id, job_id or self.job_id)

    def check_job_status(self, job_id: Optional[str] = None):
        """Per-trial metrics array."""
        return self._coordinator.job_metrics(self.session_id, job_id or self.job_id)

    def curves(self, job_id: Optional[str] = None,
               subtask_id: Optional[str] = None) -> Dict[str, Any]:
        """Learning curves captured in the fits of a job, or of one trial
        with ``subtask_id``. Each entry carries the per-split trace (loss,
        score or grad-norm channels), its rung and attempt, and the
        watchdog's ``diverged`` flag. ``job_id`` defaults to the latest
        ``train()``; KeyError for an unknown job, or a trial with no curve."""
        jid = job_id or self.job_id
        if jid is None:
            raise TypeError("curves() requires a job id (or a prior train())")
        if subtask_id is not None:
            return self._coordinator.subtask_curves(jid, subtask_id)
        out = self._coordinator.job_curves(jid)
        if out is None:
            raise KeyError(f"no job {jid!r}")
        return out

    def best_result(self, job_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        result = self.check_status(job_id).get("job_result") or {}
        return result.get("best_result")

    def download_best_model(self, job_id: Optional[str] = None,
                            output_path: Optional[str] = None) -> str:
        """Path of the job's winner artifact (``<subtask_id>_model.pkl``
        under the models directory), refitted on the first call; copied to
        ``output_path`` when given, and that path returned."""
        jid = job_id or self.job_id
        path = self._coordinator.best_model_path(self.session_id, jid)
        if path is None:
            raise FileNotFoundError("No best model artifact for this job")
        if output_path:
            import shutil

            shutil.copy(path, output_path)
            return output_path
        return path

    def load_best_model(self, job_id: Optional[str] = None, as_sklearn: bool = True):
        """Download the winning artifact and load it: by default as a fitted
        scikit-learn estimator (runtime/sklearn_export.py; raises
        ``ScikitLearnMissing`` where scikit-learn is not installed), with
        ``as_sklearn=False`` as the artifact dict, which
        ``runtime.artifacts.predict_with_artifact`` predicts with."""
        from ..runtime.artifacts import load_artifact, to_sklearn

        artifact = load_artifact(self.download_best_model(job_id))
        return to_sklearn(artifact) if as_sklearn else artifact


def _bar_postfix(bar, progress: Dict[str, Any]) -> None:
    """Adaptive-search decoration of the progress bar: the pruned and
    diverged counts and the highest rung with a report."""
    pruned = progress.get("tasks_pruned")
    diverged = progress.get("tasks_diverged")
    search = progress.get("search")
    if not pruned and not diverged and not search:
        return
    post = {}
    if pruned:
        post["pruned"] = pruned
    if diverged:
        post["diverged"] = diverged
    if isinstance(search, dict):
        rungs = [r for b in (search.get("brackets") or [search])
                 for r in (b.get("rungs") or []) if r.get("reported")]
        if rungs:
            post["rung"] = max(r["rung"] for r in rungs)
    try:
        bar.set_postfix(post, refresh=False)
    except Exception:  # noqa: BLE001 — cosmetic only
        pass


def _pct(job_status) -> float:
    if job_status in ("completed", "completed_with_failures"):
        return 100.0
    if isinstance(job_status, str) and job_status.endswith("%"):
        try:
            return float(job_status[:-1])
        except ValueError:
            return 0.0
    return 0.0
