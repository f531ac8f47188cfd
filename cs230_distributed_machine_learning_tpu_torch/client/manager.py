"""MLTaskManager: the user-facing client API, local mode.

Port of the local mode of the JAX package's ``client/manager.py``: the
manager talks directly to an in-process Coordinator. ``download_data``,
``check_data`` and ``preprocess`` stage a dataset; ``train`` accepts a
live sklearn estimator, a GridSearchCV / RandomizedSearchCV wrapper, or the
``model_details`` payload they stand for (client/introspection.py; the
form to use where scikit-learn is not installed), plus ``train_params``,
and optionally blocks until the job ends;
``check_status`` / ``check_job_status`` / ``best_result`` read results;
``download_best_model`` / ``load_best_model`` refit the winner once and
serve its artifact (runtime/artifacts.py).

The work runs on the CUDA card by default; ``device="cpu"`` runs it on
the host. Without a card and without ``device="cpu"``, construction raises.
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
    def __init__(self, coordinator=None, *, device: DeviceLike = None):
        if coordinator is None:
            from ..runtime.coordinator import Coordinator

            coordinator = Coordinator(device=device)
        self._coordinator = coordinator
        self.session_id = coordinator.create_session()
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
        ``show_progress`` is accepted; local mode draws no progress bar
        (the JAX package's behaviour with it off).
        ``dataset_name=`` is accepted as an alias for ``dataset_id``.
        ``stream=True`` (following the job's event stream) and
        ``search_params`` (adaptive search) are not yet ported and raise.
        """
        if stream:
            raise ValueError(
                "train(stream=True) is not yet ported to the PyTorch package"
            )
        if search_params is not None:
            raise ValueError(
                "train(search_params=...) (adaptive search) is not yet ported "
                "to the PyTorch package"
            )
        if dataset_name is not None:
            if dataset_id is not None and dataset_id != dataset_name:
                raise TypeError(
                    f"conflicting dataset_id={dataset_id!r} and "
                    f"dataset_name={dataset_name!r} — pass one"
                )
            dataset_id = dataset_name
        if dataset_id is None:
            raise TypeError("train() requires a dataset id (dataset_id= or dataset_name=)")
        train_params = dict(train_params or {})
        train_params.setdefault("test_size", get_config().execution.default_test_size)
        self.job_id = str(uuid.uuid4())
        payload = {
            "job_id": self.job_id,
            "session_id": self.session_id,
            "dataset_id": dataset_id,
            "model_details": extract_model_details(estimator),
            "train_params": train_params,
            "timestamp": time.time(),
        }
        submit = self._coordinator.submit_train(self.session_id, payload)
        self.job_id = submit.get("job_id") or self.job_id
        if not wait_for_completion:
            return submit
        self._coordinator.wait_for_completion(self.session_id, self.job_id, timeout)
        status = self.check_status()
        if status.get("job_status") in TERMINAL_STATUSES:
            self.result = status.get("job_result")
        return status

    def check_status(self, job_id: Optional[str] = None) -> Dict[str, Any]:
        return self._coordinator.check_status(self.session_id, job_id or self.job_id)

    def check_job_status(self, job_id: Optional[str] = None):
        """Per-trial metrics array."""
        return self._coordinator.job_metrics(self.session_id, job_id or self.job_id)

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
