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

Beyond the reference: ``search_type="asha" | "hyperband"`` expands an
adaptive-search job through ``runtime/search.py::plan_trials``. Each
trial starts at its bracket's rung 0 with the small resource budget in
its parameters and ``train_params`` ({rung, resource}); the spec's
``asha`` block carries the rung state the controller promotes and prunes
against. Promotions later re-stamp the same subtask id with the larger
budget as a fresh attempt.

Subtask ids follow the reference's ``<job_id>-subtask-<i>`` scheme.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..utils.sklearn_compat import parameter_grid, parameter_sampler

#: model_details.search_type values owned by the adaptive-search
#: controller (runtime/search.py) rather than exhaustive fan-out
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
    asha_blocks: List[Optional[Dict[str, Any]]]

    if search_type in ADAPTIVE_SEARCH_TYPES:
        from .search import plan_trials

        planned = plan_trials(model_details)
        combos = [combo for combo, _ in planned]
        asha_blocks = [block for _, block in planned]
    elif search_type == "GridSearchCV":
        combos = parameter_grid(model_details.get("param_grid") or {})
        asha_blocks = [None] * len(combos)
    elif search_type == "RandomizedSearchCV":
        combos = parameter_sampler(
            model_details.get("param_distributions") or {},
            int(model_details.get("n_iter", 10)),
            model_details.get("random_state"),
        )
        asha_blocks = [None] * len(combos)
    else:
        combos = [{}]
        asha_blocks = [None]

    cv_params = dict(model_details.get("cv_params") or {})
    subtasks = []
    for i, combo in enumerate(combos):
        params = {**base_params, **combo}
        st = {
            "subtask_id": f"{job_id}-subtask-{i}",
            "job_id": job_id,
            "session_id": session_id,
            "dataset_id": dataset_id,
            "model_type": model_type,
            "parameters": params,
            "search_params": combo,
            "train_params": {**train_params, **cv_params},
            "attempt": 0,
        }
        block = asha_blocks[i]
        if block is not None:
            st["asha"] = dict(block)
            st["parameters"] = {**params, block["resource_param"]: block["resource"]}
            st["train_params"] = {**st["train_params"], "rung": block["rung"],
                                  "resource": block["resource"]}
        subtasks.append(st)
    return subtasks
