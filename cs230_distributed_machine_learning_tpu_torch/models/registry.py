"""Model registry: sklearn class name -> kernel.

The port registers every family of the JAX package, under the same 22
names (``Imputer`` is the reference whitelist's spelling of
SimpleImputer). An unknown name raises, and the executor turns that into a
failed subtask like any other per-batch error.
"""

from __future__ import annotations

from typing import Dict, List

from .base import ModelKernel

_REGISTRY: Dict[str, ModelKernel] = {}


def get_kernel(model_type: str) -> ModelKernel:
    _ensure_populated()
    try:
        return _REGISTRY[model_type]
    except KeyError:
        raise ValueError(
            f"Unsupported model type {model_type!r}. Supported: {sorted(_REGISTRY)}"
        ) from None


def supported_models() -> List[str]:
    _ensure_populated()
    return sorted(_REGISTRY)


def _ensure_populated() -> None:
    if _REGISTRY:
        return
    from .knn import KNNClassifierKernel, KNNRegressorKernel
    from .linear import LinearRegressionKernel, RidgeKernel
    from .logistic import LogisticRegressionKernel
    from .mlp import MLPClassifierKernel, MLPRegressorKernel
    from .naive_bayes import (
        DecisionTreeClassifierKernel,
        DecisionTreeRegressorKernel,
        GaussianNBKernel,
    )
    from .svm import SVCKernel, SVRKernel
    from .transforms import (
        ImputerKernel,
        MinMaxScalerKernel,
        OneHotEncoderKernel,
        PCAKernel,
        SimpleImputerKernel,
        StandardScalerKernel,
    )
    from .trees import (
        GradientBoostingClassifierKernel,
        GradientBoostingRegressorKernel,
        RandomForestClassifierKernel,
        RandomForestRegressorKernel,
    )

    for kernel in (LogisticRegressionKernel(), LinearRegressionKernel(), RidgeKernel(),
                   RandomForestClassifierKernel(), RandomForestRegressorKernel(),
                   GradientBoostingClassifierKernel(), GradientBoostingRegressorKernel(),
                   MLPClassifierKernel(), MLPRegressorKernel(), KNNClassifierKernel(),
                   KNNRegressorKernel(), GaussianNBKernel(), DecisionTreeClassifierKernel(),
                   DecisionTreeRegressorKernel(), SVCKernel(), SVRKernel(),
                   StandardScalerKernel(), MinMaxScalerKernel(), PCAKernel(),
                   OneHotEncoderKernel(), SimpleImputerKernel(), ImputerKernel()):
        _REGISTRY[kernel.name] = kernel
