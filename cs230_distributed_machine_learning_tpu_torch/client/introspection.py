"""sklearn estimator introspection -> JSON model_details.

API parity with the reference client's ``_extract_model_details``
(``DistributedLibrary/src/distributed_ml/core.py:96-150``): accepts a live
sklearn estimator or a GridSearchCV/RandomizedSearchCV wrapper and produces
the job payload's ``model_details`` dict:

  {model_type, search_type?, base_estimator_params,
   param_grid | param_distributions + n_iter + random_state, cv_params}

Unlike the reference we also carry the search wrapper's ``random_state`` so
RandomizedSearchCV sampling is reproducible server-side (needed for
``best_params_`` parity — SURVEY.md §7 hard parts).
"""

from __future__ import annotations

from typing import Any, Dict


def extract_model_details(estimator: Any) -> Dict[str, Any]:
    try:
        from sklearn.model_selection import GridSearchCV, RandomizedSearchCV
    except ImportError:
        GridSearchCV = RandomizedSearchCV = ()  # type: ignore[assignment]

    if isinstance(estimator, dict):
        return dict(estimator)  # already a model_details payload

    if GridSearchCV and isinstance(estimator, (GridSearchCV, RandomizedSearchCV)):
        base = estimator.estimator
        details: Dict[str, Any] = {
            "model_type": type(base).__name__,
            "base_estimator_params": _clean_params(base.get_params(deep=False)),
            "cv_params": {
                "cv": estimator.cv if estimator.cv is not None else 5,
                "scoring": estimator.scoring,
            },
        }
        if isinstance(estimator, GridSearchCV):
            details["search_type"] = "GridSearchCV"
            details["param_grid"] = _jsonable_grid(estimator.param_grid)
        else:
            details["search_type"] = "RandomizedSearchCV"
            details["param_distributions"] = _jsonable_grid(estimator.param_distributions)
            details["n_iter"] = estimator.n_iter
            details["random_state"] = estimator.random_state
        return details

    # plain estimator (or anything with get_params)
    if hasattr(estimator, "get_params"):
        return {
            "model_type": type(estimator).__name__,
            "search_type": None,
            "base_estimator_params": _clean_params(estimator.get_params(deep=False)),
        }
    raise TypeError(f"Cannot extract model details from {type(estimator).__name__}")


def _clean_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only JSON-representable, non-default-ish values the kernels
    understand; drop callables/objects."""
    out = {}
    for k, v in params.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = list(v)
    return out


def _jsonable_grid(grid: Any) -> Any:
    """Param grids may contain scipy distributions (rv_frozen) for
    RandomizedSearchCV — keep them as live objects in local mode; REST mode
    serializes list-valued grids only."""
    if isinstance(grid, list):
        return [_jsonable_grid(g) for g in grid]
    if isinstance(grid, dict):
        return {k: (list(v) if isinstance(v, (list, tuple)) else v) for k, v in grid.items()}
    return grid
