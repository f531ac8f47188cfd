"""Search-space expansion: job -> per-trial subtasks.

Semantics parity with the reference's ``create_subtasks``
(``aws-prod/master/task_handler.py:156-252``):

- GridSearchCV  -> one subtask per ``sklearn.model_selection.ParameterGrid``
  combination, in ParameterGrid iteration order;
- RandomizedSearchCV -> ``ParameterSampler(param_distributions, n_iter,
  random_state)`` draws — through the port's draw-for-draw numpy copy of
  sklearn's sampler (utils/sklearn_compat.py), so the drawn configurations
  (and hence ``best_params_``) are bit-identical to what sklearn itself
  would try;
- plain estimator -> a single subtask with ``base_estimator_params``.

The JAX package's adaptive searches (``search_type="asha" | "hyperband"``)
are not ported yet and are refused at submission.

Subtask ids follow the reference's ``<job_id>-subtask-<i>`` scheme.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..utils.sklearn_compat import parameter_grid, parameter_sampler

#: model_details.search_type values of the JAX package's adaptive-search
#: controller, which the port does not have yet
ADAPTIVE_SEARCH_TYPES = ("asha", "hyperband")


def create_subtasks(
    job_id: str,
    session_id: str,
    dataset_id: str,
    model_details: Dict[str, Any],
    train_params: Dict[str, Any],
) -> List[Dict[str, Any]]:
    model_type = model_details["model_type"]
    search_type = model_details.get("search_type")
    base_params = dict(model_details.get("base_estimator_params") or {})

    if search_type in ADAPTIVE_SEARCH_TYPES:
        raise ValueError(
            f"search_type={search_type!r} is not yet ported to the PyTorch package"
        )
    if search_type == "GridSearchCV":
        combos = parameter_grid(model_details.get("param_grid") or {})
    elif search_type == "RandomizedSearchCV":
        combos = parameter_sampler(
            model_details.get("param_distributions") or {},
            int(model_details.get("n_iter", 10)),
            model_details.get("random_state"),
        )
    else:
        combos = [{}]

    cv_params = dict(model_details.get("cv_params") or {})
    return [
        {
            "subtask_id": f"{job_id}-subtask-{i}",
            "job_id": job_id,
            "session_id": session_id,
            "dataset_id": dataset_id,
            "model_type": model_type,
            "parameters": {**base_params, **combo},
            "search_params": combo,
            "train_params": {**train_params, **cv_params},
            "attempt": 0,
        }
        for i, combo in enumerate(combos)
    ]
