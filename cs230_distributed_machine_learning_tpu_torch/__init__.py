"""PyTorch / CUDA port of the distributed ML hyperparameter-search framework.

The same job model as ``cs230_distributed_machine_learning_tpu`` (the JAX
package, kept as the reference): a client (``MLTaskManager``) submits
sklearn-style training / GridSearchCV / RandomizedSearchCV jobs; a
coordinator expands them into per-trial subtasks; the trial engine fits
whole trial buckets at once on one NVIDIA GPU, with the LogisticRegression
fit driven by hand-written CUDA kernels (``csrc/``, ``ops/cuda_logreg.py``).

This package imports ``torch`` and never ``jax`` or the JAX package. Work
runs on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .version import __version__

__all__ = ["MLTaskManager", "__version__"]


def __getattr__(name):
    # lazy: importing the package must not pull in the runtime
    if name == "MLTaskManager":
        from .client.manager import MLTaskManager

        return MLTaskManager
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
