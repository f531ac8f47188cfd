"""LinearRegression and Ridge: weighted least squares in closed form.

Port of the JAX package's ``models/linear.py``. One normal-equation system
per (trial, split) lane, the intercept unpenalised and a 1e-6 jitter on the
diagonal for rank safety, solved batched over the lanes. LinearRegression
is Ridge at ``alpha = 0``; Ridge's ``alpha`` is traced (one value a lane).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .base import ModelKernel, add_intercept


class LinearRegressionKernel(ModelKernel):
    name = "LinearRegression"
    task = "regression"
    hyper_defaults: Dict[str, float] = {}
    static_defaults = {"fit_intercept": True}

    #: ridge strength where the kernel has no traced alpha
    _alpha_default = 0.0

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """Coefficients ``[L, dp]`` (the intercept last) of every lane's
        weighted normal equations: w [L, n], hypers [L]."""
        A = add_intercept(X, bool(static.get("fit_intercept", True)))
        w = w.to(torch.float32)
        dp = A.shape[1]
        alpha = hyper.get("alpha")
        alpha = (torch.full((w.shape[0],), self._alpha_default, device=A.device)
                 if alpha is None else alpha.to(torch.float32))
        pen = A.new_ones((dp,))
        if static.get("fit_intercept", True):
            pen[-1] = 0.0
        Aw = A[None] * w[..., None]  # [L, n, dp]
        gram = Aw.transpose(1, 2) @ A + torch.diag_embed(alpha[:, None] * pen + 1e-6)
        rhs = Aw.transpose(1, 2) @ y.to(torch.float32)
        return torch.linalg.solve(gram, rhs)

    def predict(self, params, X, static: Dict[str, Any]):
        """``[L, n]`` predictions."""
        A = add_intercept(X, bool(static.get("fit_intercept", True)))
        return params @ A.T

    def batched_scores(self, X, y, TW, EW, hyper, static):
        T, S = next(iter(hyper.values())).shape[0], TW.shape[0]
        lanes = {k: v.repeat_interleave(S) for k, v in hyper.items() if k != "_pad"}
        fitted = self.fit(X, y, TW.repeat(T, 1), lanes, static)
        out = self.evaluate(fitted, X, y, EW.repeat(T, 1), static)
        return {k: v.reshape(T, S) for k, v in out.items()}

    def memory_estimate_mb(self, n, d, static):
        """The lane's weighted design matrix and the products around it."""
        return max(1.0, 4.0 * n * (d + 1) * 2 / 1e6)

    def macs_estimate(self, n, d, static):
        """The closed-form solve's multiply-accumulates (the JAX formula):
        the Gram n (d+1)^2 and the (d+1)^3 solve."""
        dp = d + 1
        return float(n * dp * dp + dp**3)


class RidgeKernel(LinearRegressionKernel):
    name = "Ridge"
    hyper_defaults = {"alpha": 1.0}
    _alpha_default = 1.0
