"""Model artifact store: save and load the winner's fitted params, predict
with them on the card, and export them to scikit-learn.

Port of the JAX package's ``runtime/artifacts.py``. Parity target: the
reference pickles each fitted sklearn estimator to
``./models/<subtask_id>_model.pkl`` and serves the best one via
``/download_model`` (``worker.py:352-356``, ``master.py:270-291``). The
artifact is a plain dict ``{model_type, parameters, static,
fitted_params}`` whose params are numpy arrays and Python scalars in the
JAX package's layout (never a ``torch.Tensor``), written with ``pickle`` in
the same file name, so an artifact of either package loads in the other.

- ``predict_with_artifact`` runs the owning kernel's ``predict`` on the
  card by default (the kernel's ``params_from_artifact`` rebuilds its
  tensors there);
- ``to_sklearn`` builds the equivalent fitted scikit-learn estimator
  (runtime/sklearn_export.py); where scikit-learn is not installed it
  raises ``ScikitLearnMissing``, which names ``as_sklearn=False``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.config import get_config
from ..utils.torch_setup import DeviceLike, resolve_device


class ScikitLearnMissing(ImportError):
    """scikit-learn is needed to export an artifact and is not installed."""


def artifact_path(subtask_id: str, models_dir: Optional[str] = None) -> str:
    models_dir = models_dir or get_config().storage.models_dir
    os.makedirs(models_dir, exist_ok=True)
    return os.path.join(models_dir, f"{subtask_id}_model.pkl")


def save_artifact(subtask_id: str, artifact: Dict[str, Any],
                  models_dir: Optional[str] = None) -> str:
    path = artifact_path(subtask_id, models_dir)
    with open(path, "wb") as f:
        pickle.dump(artifact, f)
    return path


def load_artifact(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def predict_with_artifact(artifact: Dict[str, Any], X, device: DeviceLike = None) -> torch.Tensor:
    """The owning kernel's predictions for the rows of ``X`` (labels or
    targets ``[n]``; a transformer's output ``[n, d']``), as a tensor on
    ``device``: the CUDA card by default, the host with ``device="cpu"``."""
    from ..models.registry import get_kernel

    dev = resolve_device(device)
    kernel = get_kernel(artifact["model_type"])
    params = kernel.params_from_artifact(artifact["fitted_params"], dev)
    Xt = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    out = kernel.predict(params, Xt, artifact["static"])
    # the port's predict keeps its lanes (one here) before the row axis
    return out.reshape(out.shape[-(2 if kernel.task == "transform" else 1):])


def to_sklearn(artifact: Dict[str, Any]):
    """The equivalent fitted scikit-learn estimator (state injection; see
    runtime/sklearn_export.py for the per-family contracts)."""
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ScikitLearnMissing(
            "exporting an artifact as a scikit-learn estimator needs scikit-learn, "
            "which is not installed here; load_best_model(as_sklearn=False) returns "
            "the artifact dict, and predict_with_artifact predicts with it"
        ) from e
    from .sklearn_export import to_sklearn as _to_sklearn

    return _to_sklearn(artifact)
