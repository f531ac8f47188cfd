"""Model registry: sklearn class name -> kernel.

The port registers the families it has ported so far. A model type the JAX
package supports but the port does not yet raises a clear "not yet ported"
error, which the executor turns into a failed subtask like any other
per-batch error.
"""

from __future__ import annotations

from typing import Dict

from .base import ModelKernel

_REGISTRY: Dict[str, ModelKernel] = {}

#: families the JAX package runs that later slices of the port bring over
_NOT_YET_PORTED = frozenset(
    {
        "LinearRegression", "Ridge", "SVC", "SVR", "PCA", "StandardScaler", "MinMaxScaler",
        "OneHotEncoder", "SimpleImputer",
    }
)


def get_kernel(model_type: str) -> ModelKernel:
    _ensure_populated()
    try:
        return _REGISTRY[model_type]
    except KeyError:
        if model_type in _NOT_YET_PORTED:
            raise ValueError(
                f"Model type {model_type!r} is not yet ported to the PyTorch "
                f"package. Ported: {sorted(_REGISTRY)}"
            ) from None
        raise ValueError(
            f"Unsupported model type {model_type!r}. Supported: {sorted(_REGISTRY)}"
        ) from None


def _ensure_populated() -> None:
    if _REGISTRY:
        return
    from .knn import KNNClassifierKernel, KNNRegressorKernel
    from .logistic import LogisticRegressionKernel
    from .mlp import MLPClassifierKernel, MLPRegressorKernel
    from .naive_bayes import (
        DecisionTreeClassifierKernel,
        DecisionTreeRegressorKernel,
        GaussianNBKernel,
    )
    from .trees import (
        GradientBoostingClassifierKernel,
        GradientBoostingRegressorKernel,
        RandomForestClassifierKernel,
        RandomForestRegressorKernel,
    )

    for kernel in (LogisticRegressionKernel(), RandomForestClassifierKernel(),
                   RandomForestRegressorKernel(), GradientBoostingClassifierKernel(),
                   GradientBoostingRegressorKernel(), MLPClassifierKernel(),
                   MLPRegressorKernel(), KNNClassifierKernel(), KNNRegressorKernel(),
                   GaussianNBKernel(), DecisionTreeClassifierKernel(),
                   DecisionTreeRegressorKernel()):
        _REGISTRY[kernel.name] = kernel
