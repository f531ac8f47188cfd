"""Model-kernel protocol: sklearn-estimator semantics as batched torch fits.

Port of the JAX package's ``models/base.py``. Every supported model family
is a *kernel* that fits a whole bucket of trials at once. Hyperparameters
split in two groups:

- **traced hypers** — numeric values that vary across the trials of one
  batch (``C``, ``tol``, ``max_iter``); they arrive as ``[T]`` tensors;
- **static config** — anything that changes shapes or control flow
  (``penalty``, ``fit_intercept``); trials are bucketed by it.

Where the JAX package vmaps a single-trial ``fit`` over trials and splits,
the port writes the lane batch out: ``batched_scores`` takes ``[T]``
hypers and ``[S, n]`` split masks and returns ``[T, S]`` scores.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TrialData:
    """One dataset staged for trial execution (host numpy arrays). ``y`` is
    int32 class ids for classification (with ``n_classes`` > 0) or float32
    targets for regression (``n_classes`` == 0)."""

    X: Any  # [n, d] float32
    y: Any  # [n]
    n_classes: int = 0


class ModelKernel(abc.ABC):
    """Base class for all model kernels."""

    #: sklearn class name this kernel stands in for (e.g. "LogisticRegression")
    name: str = ""
    #: "classification" | "regression" | "transform"
    task: str = ""
    #: traced hyperparameter defaults, name -> float
    hyper_defaults: Dict[str, float] = {}
    #: static config defaults, name -> value
    static_defaults: Dict[str, Any] = {}
    #: sklearn get_params() noise with no bearing on the fitted function
    #: (execution knobs, deprecated placeholders) — dropped in canonicalize
    ignored_params: frozenset = frozenset(
        {
            "n_jobs",
            "verbose",
            "warm_start",
            "copy_X",
            "random_state",
            "solver",
            "multi_class",
            "dual",
            "intercept_scaling",
            "l1_ratio",
            "class_weight",
            "max_fun",
            "break_ties",
            "cache_size",
            "decision_function_shape",
            "store_cv_results",
            "copy",
            "algorithm",
            "leaf_size",
            "metric_params",
            "svd_solver",
            "iterated_power",
            "power_iteration_normalizer",
            "n_oversamples",
        }
    )

    def canonicalize(self, params: Dict[str, Any]) -> Tuple[Tuple, Dict[str, float]]:
        """Split a user parameter dict into (static_key, traced_hyper_dict).

        static_key is hashable and is the bucket key. Unknown parameters land
        in the static key so they still form distinct buckets instead of
        being silently dropped.
        """
        hyper = dict(self.hyper_defaults)
        static = dict(self.static_defaults)
        for k, v in params.items():
            if k in self.hyper_defaults:
                hyper[k] = float(v)
            elif k in self.ignored_params or v == "deprecated" or (
                v is None and k not in self.static_defaults
            ):
                continue
            else:
                static[k] = v
        static_key = tuple(sorted((k, _hashable(v)) for k, v in static.items()))
        return static_key, hyper

    def static_from_key(self, static_key: Tuple) -> Dict[str, Any]:
        return {k: v for k, v in static_key}

    def trace_salt(self) -> Tuple:
        """The env valves this kernel reads that change what it stages or
        computes without landing in ``static``: the streamed blocks' stage
        keys carry it, so a valve flip mid-process misses (the JAX
        package's ``trace_salt``). The prepared forms do not: they depend
        on ``prepared_key`` alone."""
        return ()

    @abc.abstractmethod
    def batched_scores(
        self, X, y, TW, EW, hyper: Dict[str, torch.Tensor], static: Dict[str, Any]
    ) -> Dict[str, torch.Tensor]:
        """Fit every (trial, split) lane and score it.

        X [n, d] f32, y [n] i32, TW/EW [S, n] f32 {0,1} fit / eval masks,
        hyper: name -> [T] f32. Returns {"score": [T, S]} plus optional
        ``curve_*`` leaves, all on X's device."""

    def evaluate(self, params, X, y, w, static: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Scores of lane-batched ``params`` on the rows of ``w [L, n]`` by
        the job's scorer (``static["_scoring"]``), through ``predict`` and,
        where the scorer needs them, ``predict_margin`` / ``predict_proba``."""
        return score_lanes(self, static, y, w,
                           predict=lambda: self.predict(params, X, static),
                           margin=lambda: self.predict_margin(params, X, static),
                           proba=lambda: self.predict_proba(params, X, static))

    def predict_margin(self, params, X, static: Dict[str, Any]):
        """Binary decision score, positive for class 1, needed by the margin
        scorers (roc_auc, average_precision). Kernels with a natural margin
        override it; ``validate_scoring`` refuses those scorers for the
        others."""
        raise NotImplementedError(
            f"scoring requires a decision margin, which the {self.name} kernel "
            "does not expose (supported: kernels overriding predict_margin)")

    def predict_proba(self, params, X, static: Dict[str, Any]):
        """Class probabilities ``[..., n, k]``, needed by the probability
        scorers (neg_log_loss, roc_auc_ovr/ovo). Kernels with natural
        probabilities override it."""
        raise NotImplementedError(
            f"scoring requires class probabilities, which the {self.name} kernel "
            "does not expose (supported: kernels overriding predict_proba)")

    def memory_estimate_mb(self, n: int, d: int, static: Dict[str, Any]) -> float:
        """Rough per-(trial, split) working set in MB; the trial engine
        sizes its generic-path chunks from it."""
        return max(1.0, 4.0 * n * max(d, 1) * 3 / 1e6)

    # ---- the winner artifact (runtime/artifacts.py) ----------------------
    #
    # The port's fits are lane-batched; an artifact holds one lane in the
    # JAX package's layout (its family's keys, shapes and dtypes, as host
    # numpy), so an artifact of either package loads in the other. The
    # defaults serve params whose every tensor has a leading lane axis.

    def artifact_params(self, params, lane: int = 0):
        """Lane ``lane`` of fitted ``params`` in the JAX artifact layout."""
        return tree_map(lambda t: to_host(t[lane]), params)

    def params_from_artifact(self, np_params, device):
        """The JAX artifact layout back to this kernel's params, as one lane
        on ``device``: what ``predict`` takes."""
        return tree_map(lambda a: to_device(a, device)[None], np_params)


def score_lanes(kernel: ModelKernel, static: Dict[str, Any], y, w, predict,
                margin=None, proba=None) -> Dict[str, torch.Tensor]:
    """The reference's ``evaluate`` dispatch over a batch of lanes, by the
    job's scorer (``static["_scoring"]``, None for the task's default):

    - classifiers: a margin scorer reads ``margin()`` ``[..., n]``, a
      probability scorer ``proba()`` ``[..., n, k]``, any other scorer the
      labels ``predict()`` ``[..., n]``;
    - regressors: the scorer and the MSE of ``predict()`` ``[..., n]``.

    The outputs are callables so that only the one the scorer reads is
    computed. ``y`` is ``[n]``; ``w`` the eval masks, broadcast against
    the outputs' lane dims. Returns {"score"} (plus "mse" for regressors)
    with the lane dims."""
    from ..ops import metrics as M

    scoring = static.get("_scoring")
    n_classes = static.get("_n_classes", 2)
    if kernel.task == "classification":
        y = y.long()
        if M.scoring_needs_margin(scoring):
            return {"score": M.margin_score(scoring, y, margin(), w)}
        if M.scoring_needs_proba(scoring):
            return {"score": M.proba_score(scoring, y, proba(), w, n_classes)}
        return {"score": M.classification_score(scoring, y, predict(), w, n_classes)}
    pred = predict()
    y = y.to(torch.float32)
    return {"score": M.regression_score(scoring, y, pred, w), "mse": M.weighted_mse(y, pred, w)}


def add_intercept(X: torch.Tensor, fit_intercept: bool) -> torch.Tensor:
    """[X | 1] design matrix when fitting an intercept."""
    X = X.to(torch.float32)
    if not fit_intercept:
        return X
    return torch.cat([X, X.new_ones((X.shape[0], 1))], dim=1)


def tree_map(fn, tree):
    """``fn`` over the array leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_host(t) -> np.ndarray:
    """An artifact leaf: host numpy in the JAX package's dtypes (int64 as
    int32, float64 as float32, as JAX keeps them without x64)."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def to_device(a, device) -> torch.Tensor:
    """An artifact leaf as a port tensor: integers as int64 (the port
    indexes with them), floats as float32."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a.astype(np.float32), device=device)
    return torch.as_tensor(a, device=device)


def _hashable(v: Any):
    if isinstance(v, (list, np.ndarray)):
        return tuple(np.asarray(v).ravel().tolist())
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v
