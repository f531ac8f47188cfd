"""Transformer kernels: StandardScaler, MinMaxScaler, PCA, OneHotEncoder and
SimpleImputer (also registered as ``Imputer``).

Port of the JAX package's ``models/transforms.py``, with its contract:
``fit`` learns statistics on the weight-masked rows of every lane (w
``[L, n]``), ``predict`` is ``transform`` (the transformed matrix of each
lane, ``[L, n, d']``), and ``evaluate`` reports a transform's score so that
searches over transformer parameters still rank: explained variance for
PCA, the fraction of finite cells after imputation for SimpleImputer, 1.0
for the others. OneHotEncoder pads every column to ``max_categories``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .base import ModelKernel

_EPS = 1e-12


class _TransformBase(ModelKernel):
    task = "transform"

    def evaluate(self, params, X, y, w, static: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {"score": w.new_ones(w.shape[:-1], dtype=torch.float32)}

    def batched_scores(self, X, y, TW, EW, hyper, static):
        """``[T, S]`` scores: lane = trial * S + split; the transformers
        have no traced hypers (``hyper`` carries the trial count)."""
        T, S = next(iter(hyper.values())).shape[0], TW.shape[0]
        fitted = self.fit(X, y, TW.repeat(T, 1), {}, static)
        out = self.evaluate(fitted, X, y, EW.repeat(T, 1), static)
        return {k: v.reshape(T, S) for k, v in out.items()}


def _masked_mean(X, w):
    """``[L, d]`` weighted column means and the weight sums ``[L, 1]``."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    return (w @ X) / wsum, wsum


class StandardScalerKernel(_TransformBase):
    name = "StandardScaler"
    static_defaults = {"with_mean": True, "with_std": True}

    def fit(self, X, y, w, hyper, static):
        X, w = X.to(torch.float32), w.to(torch.float32)
        mean, wsum = _masked_mean(X, w)
        var = torch.einsum("ln,lnd->ld", w, (X[None] - mean[:, None]) ** 2) / wsum
        return {"mean": mean, "scale": torch.sqrt(torch.clamp(var, min=_EPS))}

    def predict(self, params, X, static):
        X = X.to(torch.float32)[None]
        if static.get("with_mean", True):
            X = X - params["mean"][:, None]
        if static.get("with_std", True):
            X = X / params["scale"][:, None]
        return X


class MinMaxScalerKernel(_TransformBase):
    name = "MinMaxScaler"
    static_defaults = {"feature_range": (0, 1), "clip": False}

    def fit(self, X, y, w, hyper, static):
        X = X.to(torch.float32)[None]
        sel = w[..., None] > 0
        big = 3.4e38
        return {"min": torch.amin(torch.where(sel, X, torch.full_like(X, big)), dim=1),
                "max": torch.amax(torch.where(sel, X, torch.full_like(X, -big)), dim=1)}

    def predict(self, params, X, static):
        lo, hi = static.get("feature_range", (0, 1))
        lo_x, hi_x = params["min"][:, None], params["max"][:, None]
        span = torch.clamp(hi_x - lo_x, min=_EPS)
        out = (X.to(torch.float32)[None] - lo_x) / span * (hi - lo) + lo
        if static.get("clip", False):
            out = torch.clamp(out, lo, hi)
        return out


class PCAKernel(_TransformBase):
    name = "PCA"
    static_defaults = {"n_components": 2, "whiten": False}

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        nc = static.get("n_components") or min(n, d)
        if isinstance(nc, float) and 0 < nc < 1:
            raise ValueError("PCA: fractional n_components not supported (pass an int)")
        return {**static, "n_components": min(int(nc), d)}

    def fit(self, X, y, w, hyper, static):
        """Each lane's weighted covariance, its eigenvectors in descending
        eigenvalue order (their signs are eigh's, arbitrary as in the
        reference) and the explained variance and its ratio."""
        X, w = X.to(torch.float32), w.to(torch.float32)
        mean, wsum = _masked_mean(X, w)
        Xc = (X[None] - mean[:, None]) * torch.sqrt(w)[..., None]
        cov = Xc.transpose(1, 2) @ Xc / torch.clamp(wsum - 1.0, min=1.0)[..., None]
        evals, evecs = torch.linalg.eigh(cov)  # ascending
        k = int(static["n_components"])
        var = evals.flip(-1)[:, :k]
        total = torch.clamp(torch.sum(evals, dim=-1, keepdim=True), min=_EPS)
        return {"mean": mean, "components": evecs.flip(-1)[..., :k].transpose(1, 2),
                "explained_variance": var, "explained_variance_ratio": var / total}

    def predict(self, params, X, static):
        Z = (X.to(torch.float32)[None] - params["mean"][:, None]) @ \
            params["components"].transpose(1, 2)
        if static.get("whiten", False):
            Z = Z / torch.sqrt(torch.clamp(params["explained_variance"], min=_EPS))[:, None]
        return Z

    def evaluate(self, params, X, y, w, static):
        return {"score": torch.sum(params["explained_variance_ratio"], dim=-1)}


class OneHotEncoderKernel(_TransformBase):
    name = "OneHotEncoder"
    static_defaults = {"max_categories": 32}

    def fit(self, X, y, w, hyper, static):
        """Integer-coded columns: each lane's per-column largest code on its
        rows, so that transform masks codes it never saw."""
        X = X.to(torch.int32)[None]
        sel = w[..., None] > 0
        return {"n_cats": torch.amax(torch.where(sel, X, torch.full_like(X, -1)), dim=1) + 1}

    def predict(self, params, X, static):
        cap = int(static.get("max_categories", 32))
        codes = torch.arange(cap, device=X.device)
        onehot = (X.to(torch.int32)[..., None] == codes).to(torch.float32)  # [n, d, cap]
        valid = codes < params["n_cats"][..., None]  # [L, d, cap]
        out = onehot[None] * valid[:, None]
        return out.reshape(out.shape[0], X.shape[0], -1)


class SimpleImputerKernel(_TransformBase):
    name = "SimpleImputer"
    static_defaults = {"strategy": "mean", "fill_value": 0.0}

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        if static.get("strategy") not in ("mean", "median", "constant"):
            raise ValueError(f"SimpleImputer: unsupported strategy {static.get('strategy')!r}")
        return dict(static)

    def fit(self, X, y, w, hyper, static):
        X = X.to(torch.float32)
        obs = torch.isfinite(X)[None] & (w[..., None] > 0)  # [L, n, d]
        strategy = static.get("strategy", "mean")
        if strategy == "median":
            fill = _nanmedian(torch.where(obs, X[None], torch.full_like(obs, float("nan"),
                                                                         dtype=torch.float32)))
        elif strategy == "constant":
            fill = torch.full((w.shape[0], X.shape[1]), float(static.get("fill_value", 0.0)),
                              dtype=torch.float32, device=X.device)
        else:
            cnt = torch.clamp(torch.sum(obs, dim=1), min=1)
            fill = torch.sum(torch.where(obs, X[None], torch.zeros_like(X[None])), dim=1) / cnt
        return {"fill": torch.nan_to_num(fill)}

    def predict(self, params, X, static):
        X = X.to(torch.float32)[None]
        return torch.where(torch.isfinite(X), X, params["fill"][:, None])

    def evaluate(self, params, X, y, w, static):
        out = self.predict(params, X, static)
        return {"score": torch.mean(torch.isfinite(out).to(torch.float32), dim=(1, 2))}


def _nanmedian(Xm):
    """Column medians ``[L, d]`` of ``[L, n, d]`` ignoring NaNs, as
    ``jnp.nanmedian``: NaNs sort last, and an even count takes the linear
    interpolation of its two middle values (half of each), where
    ``torch.nanmedian`` would take the lower one."""
    s = torch.sort(Xm, dim=1).values
    cnt = torch.sum(~torch.isnan(Xm), dim=1, keepdim=True).to(torch.float32)
    pos = 0.5 * (cnt - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    top = torch.clamp(cnt - 1.0, min=0.0)
    low = torch.minimum(torch.clamp(low, min=0.0), top).long()
    high = torch.minimum(torch.clamp(high, min=0.0), top).long()
    out = torch.gather(s, 1, low) * (1.0 - high_w) + torch.gather(s, 1, high) * high_w
    return out[:, 0]


class ImputerKernel(SimpleImputerKernel):
    """The reference whitelist's spelling of SimpleImputer."""

    name = "Imputer"
