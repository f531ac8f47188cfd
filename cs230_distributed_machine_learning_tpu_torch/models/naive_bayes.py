"""GaussianNB and the single decision trees.

Port of the JAX package's ``models/naive_bayes.py``. GaussianNB is three
weighted moment reductions per lane, with f32 products (TF32 stays off,
utils/torch_setup.py); the decision trees are the forests' histogram
builders with one tree, no bootstrap and no fold-in: the tree key is
``PRNGKey(random_state)``. A DecisionTreeClassifier histograms integer
stats (B4's int32 mode), a DecisionTreeRegressor float ``y * w`` (B4's f32
mode); ``max_depth=None`` above ``CS230_TREE_DEEP_N`` rows grows in the
deep arena.

Every function works on an explicit lane axis L = trials x splits (the
JAX package vmaps instead).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..utils import prng
from .base import ModelKernel, score_lanes, to_device, to_host
from .trees import _normalised, _TreeBase, _vote_outputs

_EPS = 1e-9


def _trial_lanes(hyper, TW, EW):
    """(T, S, fit weights [T*S, n], eval weights [T*S, n], per-lane hypers):
    lane = trial * S + split."""
    T, S = next(iter(hyper.values())).shape[0], TW.shape[0]
    lanes = {k: v.repeat_interleave(S) for k, v in hyper.items()}
    return T, S, TW.repeat(T, 1), EW.repeat(T, 1), lanes


class GaussianNBKernel(ModelKernel):
    name = "GaussianNB"
    task = "classification"
    hyper_defaults = {"var_smoothing": 1e-9}
    static_defaults: Dict[str, Any] = {}

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """Per-lane class means, variances (plus var_smoothing times the
        lane's largest feature variance) and log priors: w [L, n]."""
        c = max(int(static["_n_classes"]), 2)
        X = X.to(torch.float32)
        w = w.to(torch.float32)
        Y = torch.nn.functional.one_hot(y.long(), c).to(torch.float32)[None] * w[..., None]
        counts = torch.clamp(Y.sum(dim=1), min=_EPS)  # [L, c]
        mean = torch.einsum("lnc,nd->lcd", Y, X) / counts[..., None]
        sq = torch.einsum("lnc,nd->lcd", Y, X * X) / counts[..., None]
        var = torch.clamp(sq - mean**2, min=0.0)
        wsum = torch.clamp(w.sum(dim=-1), min=_EPS)[:, None]  # [L, 1]
        gmean = (w @ X) / wsum
        gvar = torch.einsum("ln,lnd->ld", w, (X[None] - gmean[:, None]) ** 2) / wsum
        var_smoothing = hyper["var_smoothing"].to(torch.float32)
        var = var + (var_smoothing * gvar.amax(dim=-1))[:, None, None]
        prior = counts / counts.sum(dim=-1, keepdim=True)
        return {"mean": mean, "var": var, "log_prior": torch.log(prior)}

    def _log_joint(self, params, X):
        """``[L, n, c]`` per-class Gaussian log likelihood plus log prior."""
        X = X.to(torch.float32)
        mean, var = params["mean"], params["var"]  # [L, c, d]
        ll = -0.5 * torch.sum(
            torch.log(2 * math.pi * var)[:, None]
            + (X[None, :, None, :] - mean[:, None]) ** 2 / var[:, None],
            dim=-1,
        )
        return ll + params["log_prior"][:, None, :]

    def memory_estimate_mb(self, n: int, d: int, static: Dict[str, Any]) -> float:
        """The log likelihood's ``[n, c, d]`` terms (two live at once) and
        the one-hot stats, per lane."""
        c = max(int(static.get("_n_classes", 2)), 2)
        return max(1.0, 4.0 * n * (2 * c * d + c + 2 * d) / 1e6)

    def predict(self, params, X, static):
        return torch.argmax(self._log_joint(params, X), dim=-1)

    def predict_margin(self, params, X, static):
        lj = self._log_joint(params, X)
        return lj[..., 1] - lj[..., 0]

    def predict_proba(self, params, X, static):
        """The normalised joint likelihood (sklearn's predict_proba)."""
        return torch.softmax(self._log_joint(params, X), dim=-1)

    def batched_scores(self, X, y, TW, EW, hyper, static):
        T, S, w, ew, lanes = _trial_lanes(hyper, TW, EW)
        out = self.evaluate(self.fit(X, y, w, lanes, static), X, y, ew, static)
        return {"score": out["score"].reshape(T, S)}


class _DecisionTreeBase(_TreeBase):
    _supports_deep = True  # sklearn's max_depth=None grows to purity
    static_defaults = {
        "max_depth": None,
        "min_samples_leaf": 1,
        "min_samples_split": 2,
        "max_features": None,
        "random_state": 0,
        "n_bins": 128,
        "criterion": "default",
        "splitter": "best",
        "min_weight_fraction_leaf": 0.0,
        "max_leaf_nodes": None,
        "min_impurity_decrease": 0.0,
        "ccp_alpha": 0.0,
        "monotonic_cst": None,
    }
    _mf_default = 1.0

    def fit(self, X, y, w, hyper, static):
        """One tree per lane, keyed ``PRNGKey(random_state)``: w [L, n];
        the subclass's ``_stat_matrix`` gives the stats ``[L, n, k]``."""
        w = w.to(torch.float32)
        key = prng.PRNGKey(static["_seed"], device=w.device)
        tree = self._fit_one_tree(X, self._stat_matrix(y, w, static), w, static, key)
        return self._with_edges({"tree": tree}, X)

    def artifact_params(self, params, lane: int = 0):
        """The lane's tree and the bin edges (the JAX layout)."""
        tree = {k: to_host(v[lane]) for k, v in params["tree"].items()}
        return self._edges_artifact(params, {"tree": tree})

    def params_from_artifact(self, np_params, device):
        tree = {k: to_device(v, device)[None] for k, v in np_params["tree"].items()}
        return self._edges_artifact(np_params, {"tree": tree}, device)

    def batched_scores(self, X, y, TW, EW, hyper, static):
        """``[T, S]`` scores; the trees have no traced hypers, ``hyper``
        carries only the trial count."""
        T, S, w, ew, _ = _trial_lanes(hyper, TW, EW)
        out = self.evaluate(self.fit(X, y, w, {}, static), X, y, ew, static)
        return {k: v.reshape(T, S) for k, v in out.items()}

    def _leaf(self, params, X, static):
        """Every lane's leaf values ``[L, n, k]`` at X's rows."""
        return self._tree_predict(self._query_bins(params, X, static), params["tree"], static)

    def evaluate(self, params, X, y, w, static):
        leaf = self._leaf(params, X, static)
        if self.task == "classification":
            return score_lanes(self, static, y, w, **_vote_outputs(leaf))
        return score_lanes(self, static, y, w, predict=lambda: leaf[..., 0])


class DecisionTreeClassifierKernel(_DecisionTreeBase):
    name = "DecisionTreeClassifier"
    task = "classification"

    def _stat_matrix(self, y, w, static):
        c = max(int(static["_n_classes"]), 2)
        return torch.nn.functional.one_hot(y.long(), c).to(torch.float32)[None] * w[..., None]

    def predict(self, params, X, static):
        """Labels ``[L, n]``: the leaf's first-index argmax."""
        return torch.argmax(self._leaf(params, X, static), dim=-1)

    def predict_margin(self, params, X, static):
        leaf = self._leaf(params, X, static)
        return leaf[..., 1] - leaf[..., 0]

    def predict_proba(self, params, X, static):
        """The leaf class distribution (sklearn's tree predict_proba),
        normalised."""
        return _normalised(self._leaf(params, X, static))


class DecisionTreeRegressorKernel(_DecisionTreeBase):
    name = "DecisionTreeRegressor"
    task = "regression"

    def _stat_matrix(self, y, w, static):
        return (y.to(torch.float32)[None] * w)[..., None]

    def predict(self, params, X, static):
        """The leaf values ``[L, n]``."""
        return self._leaf(params, X, static)[..., 0]
