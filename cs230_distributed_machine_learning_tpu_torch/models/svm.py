"""SVM kernels: SVC and SVR, solved on the device.

Port of the JAX package's ``models/svm.py``. Two solvers, chosen per bucket
from the table's size (``resolve_static``):

- **the exact dual** (n <= ``_MAX_N``): the C-SVM dual over the box AND the
  ``sum(t * alpha) = 0`` hyperplane (libsvm's constraint set), by FISTA
  ascent with a 1/lambda_max step, each step projected onto the box and
  hyperplane by bisection, stopping when the iterate stops moving (the KKT
  displacement test); intercepts from the KKT conditions over the free
  support vectors. SVC fits all its one-vs-one machines in one ascent: A
  ``[n, P]``, one ``[n, n] x [n, P]`` product a step. The RBF Gram streams
  as bf16 (rounded operands, f32 products and sums);
- **the Nyström primal** (n > ``_MAX_N``): m landmark rows give features
  ``Z = K(X, L) K_LL^{-1/2}``, and each machine solves the primal
  squared-hinge (SVC) or huberised epsilon-insensitive (SVR) objective on
  Z by Nesterov descent.

Lanes. The reference vmaps one fit over (trial, split) lanes, each lane
holding its own Gram. Here ``fit`` takes the S split masks and the T
trials' hypers at once: the Gram (or the Nyström features) depends only on
the split, through ``gamma="scale"``, so it is built once a split and
shared by the trials, and every product runs over all lanes. A lane freezes
at its own KKT stop, as in the reference's vmapped while loop; the loop
ends when no lane is live (tested on the host every ``_LIVE_CHECK``
steps; a frozen lane does not change, so the interval changes no result).

Hypers: ``C`` (traced), SVR's ``epsilon`` (traced), ``gamma`` numeric (a
bucket each) or "scale"/"auto" (from the lane's masked rows, like
sklearn). ``kernel`` ("rbf" | "linear" | "poly") is static. The valves
keep the reference's names: ``CS230_SVM_PG_STEPS``, ``CS230_SVM_KKT_TOL``,
``CS230_SVM_NYSTROM_STEPS``, ``CS230_SVM_NYSTROM_M`` and
``CS230_SVM_KMEANS_ITERS`` (Lloyd iterations refining the Nyström
landmarks, ``_kmeans_landmarks``; off by default, as in the reference).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from .base import ModelKernel, to_device, to_host

_PG_STEPS = int(os.environ.get("CS230_SVM_PG_STEPS", "600"))
_MAX_N = 30_000
#: solver steps between the host's checks for a live lane
_LIVE_CHECK = 16
#: the dual ascents since ``reset_dual_stops``: their count, and the step
#: at which the slowest lane of any of them stopped
DUAL_STOPS = {"ascents": 0, "slowest_stop": 0}


def reset_dual_stops() -> None:
    for k in DUAL_STOPS:
        DUAL_STOPS[k] = 0


def _pg_steps() -> int:
    return int(os.environ.get("CS230_SVM_PG_STEPS", _PG_STEPS))


def _nystrom_steps() -> int:
    """Nesterov steps of the Nyström primal solve (the reference's 1200)."""
    return int(os.environ.get("CS230_SVM_NYSTROM_STEPS", "1200"))


def _nystrom_m(n: int) -> int:
    """Landmarks of the Nyström path: n / 16 within [2048, 4096]."""
    env = os.environ.get("CS230_SVM_NYSTROM_M")
    if env:
        return int(env)
    return int(min(4096, max(2048, n // 16)))


def _kmeans_iters() -> int:
    """Lloyd iterations refining the Nyström landmarks (default 0: off).
    The reference measured k-means landmarks worse than uniform rows on
    covertype (CV 0.798 against 0.897 at the same m and solve: 44 of its 54
    features are binary, and centroids leave the data's manifold); the
    valve is for continuous-feature tables."""
    return int(os.environ.get("CS230_SVM_KMEANS_ITERS", "0"))


def _kmeans_landmarks(X: torch.Tensor, init: torch.Tensor, iters: int,
                      chunk: int = 16384) -> torch.Tensor:
    """Lloyd's k-means refinement of the landmarks ``init [m, d]`` over the
    rows of ``X [n, d]`` (the reference's ``_kmeans_landmarks``): each
    iteration assigns every row to its nearest center (``||c||^2 - 2 x.c``,
    the row's own norm dropped; first index on ties) and averages each
    cluster's rows, in row chunks of ``chunk`` summed in row order; the sums
    take the rows bf16-rounded with f32 accumulation, as the reference's
    bf16 one-hot product does, but add each row to its cluster directly
    (``index_add_``) rather than through an ``[chunk, m]`` one-hot. An
    empty cluster keeps its center. Plain tensor operations: the
    reference's are XLA's, outside any kernel."""
    n, d = X.shape
    C = init.to(torch.float32)
    m = C.shape[0]
    chunk = min(chunk, n)
    for _ in range(int(iters)):
        cn = torch.sum(C * C, dim=1)
        sums = X.new_zeros((m, d))
        counts = X.new_zeros((m,))
        for start in range(0, n, chunk):
            xb = X[start:start + chunk]
            a = torch.argmin(cn[None, :] - 2.0 * (xb @ C.T), dim=1)
            sums.index_add_(0, a, _round_bf16(xb))
            counts += torch.bincount(a, minlength=m).to(torch.float32)
        C = torch.where(counts[:, None] > 0.5, sums / torch.clamp(counts[:, None], min=1.0), C)
    return C


def _kkt_tol() -> float:
    """The dual ascent's stop: iterate displacement relative to C; 0 runs
    the full step count."""
    return float(os.environ.get("CS230_SVM_KKT_TOL", "1e-3"))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values kept in f32: a product of two of them is exact in
    f32, so an f32 product of the rounded operands is the reference's bf16
    dot with f32 accumulation (TF32 is off)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _gram(X1, X2, kernel: str, gamma, degree, coef0):
    """``[G, n1, n2]`` kernel matrices, one a gamma (``gamma [G]``); the
    linear kernel has no gamma and returns one ``[1, n1, n2]``."""
    P = X1 @ X2.T
    if kernel == "linear":
        return P[None]
    g = gamma[:, None, None]
    if kernel == "poly":
        return (g * P + coef0) ** degree
    d2 = torch.sum(X1 * X1, dim=1)[:, None] + torch.sum(X2 * X2, dim=1)[None, :] - 2.0 * P
    return torch.exp(-g * torch.clamp(d2, min=0.0))


def _per_split(K, V):
    """``K [G, n, n2] @ V [T, S, n2, P]`` split by split (G is S, or 1 for
    a Gram shared by every split): ``[T, S, n, P]``."""
    T, S, n2, P = V.shape
    out = K @ V.permute(1, 2, 0, 3).reshape(S, n2, T * P)  # [S, n, T * P]
    return out.reshape(S, -1, T, P).permute(2, 0, 1, 3)


def _project_box_hyperplane_cols(A_raw, TS, hi, iters: int = 30):
    """Euclidean projection of each column of ``A_raw [..., n, P]`` onto
    {0 <= a <= hi, sum(TS * a) = 0} (TS in {-1, 0, +1}) by bisection on the
    hyperplane's multiplier: phi(lam) = sum(TS * clip(A_raw - lam TS, 0,
    hi)) is non-increasing in lam. The bracket is the lane's max(hi) +
    max|A_raw| + 1."""
    def phi(lam):
        return torch.sum(TS * _clip(A_raw - lam[..., None, :] * TS, hi), dim=-2)

    span = (torch.amax(hi, dim=(-2, -1)) + torch.amax(torch.abs(A_raw), dim=(-2, -1))
            + 1.0)[..., None].expand(A_raw.shape[:-2] + A_raw.shape[-1:])
    lo_l, hi_l = -span, span
    for _ in range(iters):
        mid = 0.5 * (lo_l + hi_l)
        right = phi(mid) > 0
        lo_l, hi_l = torch.where(right, mid, lo_l), torch.where(right, hi_l, mid)
    lam = 0.5 * (lo_l + hi_l)
    return _clip(A_raw - lam[..., None, :] * TS, hi)


def _clip(x, hi):
    """clip(x, 0, hi) with a tensor upper bound."""
    return torch.minimum(torch.clamp(x, min=0.0), hi)


def _fista_ascent(qmatvec, TS, lin, hi, eta, steps: int, diag):
    """FISTA on every lane of ``lin [T, S, n, P]``: maximise lin.x -
    0.5 x'Qx - 0.5 diag ||x||^2 over the box ``[0, hi]`` and each
    column's hyperplane, stopping a lane once its projected iterate moves
    less than the KKT tolerance times its box size (a fixed point of the
    projected step is a KKT point). A stopped lane keeps its carry.
    Returns (x, the step count each lane stopped at ``[T, S]``)."""
    tol = _kkt_tol()
    lanes = lin.shape[:2]
    x = torch.zeros_like(lin)
    x_prev = x
    tk = lin.new_ones(lanes)
    k = torch.zeros(lanes, dtype=torch.int32, device=lin.device)
    res = lin.new_full(lanes, float("inf"))
    scale = torch.clamp(torch.amax(hi, dim=(-2, -1)), min=1e-12)
    for it in range(steps):
        live = res > tol * scale if tol > 0 else torch.ones_like(res, dtype=torch.bool)
        if it % _LIVE_CHECK == 0 and not bool(live.any()):
            break
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        y = x + ((tk - 1.0) / t_next)[..., None, None] * (x - x_prev)
        g = lin - qmatvec(y) - diag * y
        x_new = _project_box_hyperplane_cols(y + eta * g, TS, hi)
        res_new = torch.amax(torch.abs(x_new - x), dim=(-2, -1))
        lv = live[..., None, None]
        x, x_prev = torch.where(lv, x_new, x), torch.where(lv, x, x_prev)
        tk = torch.where(live, t_next, tk)
        k = torch.where(live, k + 1, k)
        res = torch.where(live, res_new, res)
    DUAL_STOPS["ascents"] += 1
    DUAL_STOPS["slowest_stop"] = max(DUAL_STOPS["slowest_stop"], int(k.max()))
    return x, k


def _power_lambda_max(qmatvec, n: int, like: torch.Tensor, iters: int = 25):
    """lambda_max of each column's operator by power iteration from the
    reference's waveform cos(1.7 i + 0.3) (an all-ones start lies in the
    SVR block matrix's null space): ``[..., 1, P]`` for ``like [..., n, P]``."""
    v = torch.cos(1.7 * torch.arange(n, dtype=torch.float32, device=like.device) + 0.3)
    v = v[:, None].expand(like.shape).contiguous()
    for _ in range(iters):
        u = qmatvec(v)
        v = u / torch.clamp(torch.linalg.vector_norm(u, dim=-2, keepdim=True), min=1e-12)
    return torch.clamp(torch.sum(v * qmatvec(v), dim=-2, keepdim=True), min=1e-6)


def _nesterov_primal(grad_fn, w0, L_est, steps: int):
    """min f(w) by Nesterov descent with the analytic Lipschitz step
    ``L_est [..., 1, 1]``, a fixed step count."""
    w, w_prev = w0, w0
    for t in range(steps):
        mom = float(np.float32(t) / np.float32(t + 3.0))
        v = w + mom * (w - w_prev)
        w, w_prev = v - grad_fn(v) / L_est, w
    return w


class SVCKernel(ModelKernel):
    name = "SVC"
    task = "classification"
    hyper_defaults = {"C": 1.0}
    static_defaults = {"kernel": "rbf", "gamma": "scale", "degree": 3, "coef0": 0.0}

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        if static.get("kernel") not in ("rbf", "linear", "poly"):
            raise ValueError(f"{self.name}: unsupported kernel {static.get('kernel')!r}")
        g = static.get("gamma", "scale")
        if isinstance(g, (int, float)):
            static = {**static, "_gamma_mode": "numeric", "_gamma_value": float(g)}
        else:
            static = {**static, "_gamma_mode": g}
        if n > _MAX_N:
            static = {**static, "_nystrom": True, "_m": min(_nystrom_m(n), n)}
        return static

    def memory_estimate_mb(self, n, d, static):
        """The reference's per-lane working set: the Gram and its bf16 copy,
        or the Nyström features twice (the port shares them across the
        trials of a split, so this is an upper bound)."""
        if static.get("_nystrom"):
            m = int(static.get("_m", 2048)) + 1
            return max(1.0, 4.0 * (2.0 * n * m + n * d) / 1e6)
        return max(1.0, 4.0 * (n * n * 2 + n * d) / 1e6)

    # ---- shared machinery ------------------------------------------------

    def _gamma(self, X, w, static):
        """``[S]`` gammas of the split masks w [S, n]: sklearn's "scale" (one
        over d times the masked rows' variance), "auto" (1 / d) or a number."""
        S, d = w.shape[0], X.shape[1]
        if static.get("_gamma_mode") == "numeric":
            return X.new_full((S,), float(static["_gamma_value"]))
        if static.get("_gamma_mode") == "auto":
            return X.new_full((S,), 1.0 / d)
        w = w.to(torch.float32)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        mean = (w @ X) / wsum[:, None]
        var = torch.einsum("sn,snd->s", w, (X[None] - mean[:, None]) ** 2) / (wsum * d)
        return 1.0 / torch.clamp(d * var, min=1e-12)

    def _kernel_of(self, X1, X2, gamma, static):
        return _gram(X1, X2, static["kernel"], gamma, static.get("degree", 3),
                     static.get("coef0", 0.0))

    def _nystrom_Z(self, X, gamma, static):
        """Per split: features ``Z [G, n, m + 1]`` (the landmarks' kernel
        whitened by K_LL^{-1/2}, eigh's spectrum floored at 1e-6, then a
        ones column), the landmarks, ``K_LL^{-1/2} [G, m, m]`` and
        lambda_max(Z'Z) ``[G]`` by 20 power steps. The landmark draw is the
        reference's numpy ``RandomState(17)``, refined by
        ``CS230_SVM_KMEANS_ITERS`` Lloyd iterations over the whole table
        when set; Z is built one split at a time to bound the peak memory."""
        n = X.shape[0]
        m = int(static["_m"])
        idx = np.random.RandomState(17).choice(n, m, replace=False)
        landmarks = X[torch.as_tensor(idx, device=X.device)]
        iters = _kmeans_iters()
        if iters > 0:
            landmarks = _kmeans_landmarks(X, landmarks, iters)
        G = 1 if static["kernel"] == "linear" else gamma.shape[0]
        Z = X.new_empty((G, n, m + 1))
        Z[..., m] = 1.0
        inv = X.new_empty((G, m, m))
        for g in range(G):
            KLL = self._kernel_of(landmarks, landmarks, gamma[g:g + 1], static)[0]
            vals, vecs = torch.linalg.eigh(KLL)
            inv[g] = vecs * torch.rsqrt(torch.clamp(vals, min=1e-6))[None, :]
            Z[g, :, :m] = self._kernel_of(X, landmarks, gamma[g:g + 1], static)[0] @ inv[g]
        v = X.new_ones((G, m + 1, 1))
        for _ in range(20):
            u = Z.transpose(1, 2) @ (Z @ v)
            v = u / torch.clamp(torch.linalg.vector_norm(u, dim=1, keepdim=True), min=1e-12)
        lam_max = torch.clamp(torch.sum(v * (Z.transpose(1, 2) @ (Z @ v)), dim=(1, 2)),
                              min=1e-6)
        return Z, landmarks, inv, lam_max

    def _query_features(self, params, Xq, static):
        """Nyström features of query rows ``[G, nq, m + 1]``; the fit's own
        Z where the query is the fitted table (the search path)."""
        if Xq is params.get("X"):
            return params["Z"]
        Zq = self._kernel_of(Xq, params["landmarks"], params["gamma"], static) @ params["inv_sqrt"]
        return torch.cat([Zq, Zq.new_ones(Zq.shape[:-1] + (1,))], dim=-1)

    # ---- the artifact: one (trial, split) lane in the JAX layout ---------
    #
    # Lane l is (trial l // S, split l % S) of the fit's ``[T, S]`` lanes.
    # The exact dual keeps the table; the Nyström primal keeps the
    # landmarks and K_LL^{-1/2} (one a split, or one shared by a linear
    # kernel). The search path's products of the fitted rows (F, K, Z) and
    # the step count are not part of it.

    def artifact_params(self, params, lane: int = 0):
        S = params["gamma"].shape[0]
        t, s = divmod(lane, S)
        out = {"gamma": to_host(params["gamma"][s])}
        if "W" in params:
            inv = params["inv_sqrt"]
            out.update(W=self._lane_w(params["W"][t, s]), landmarks=to_host(params["landmarks"]),
                       inv_sqrt=to_host(inv[min(s, inv.shape[0] - 1)]))
        else:
            out.update(X=to_host(params["X"]), dual=self._lane_w(params["dual"][t, s]),
                       intercept=to_host(params["intercept"][t, s]))
        if "pairs_a" in params:
            out.update(pairs_a=to_host(params["pairs_a"]), pairs_b=to_host(params["pairs_b"]))
        return out

    @staticmethod
    def _lane_w(v):
        """A lane's ``[n, P]`` duals or ``[m + 1, P]`` weights as the JAX
        ``[P, ...]``."""
        return to_host(v.T)

    def params_from_artifact(self, np_params, device):
        p = {k: to_device(v, device) for k, v in np_params.items()}
        p["gamma"] = p["gamma"].reshape(1)
        if "inv_sqrt" in p:
            p["inv_sqrt"] = p["inv_sqrt"][None]
        if "intercept" in p:
            p["intercept"] = p["intercept"][None, None]
        for k in ("W", "dual"):
            if k in p:
                p[k] = self._unlane_w(p[k])[None, None]
        return p

    @staticmethod
    def _unlane_w(a):
        """Inverse of ``_lane_w``."""
        return a.T

    # ---- SVC ---------------------------------------------------------------

    @staticmethod
    def _pairs(c: int):
        return [(i, j) for i in range(c) for j in range(i + 1, c)]

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """Every OvO machine of T trials x S splits: w [S, n] split masks,
        ``hyper["C"] [T]``. Params hold lane dims ``[T, S]``."""
        X = X.to(torch.float32)
        w = w.to(torch.float32)
        c = max(int(static["_n_classes"]), 2)
        C = hyper["C"].to(torch.float32)
        gamma = self._gamma(X, w, static)
        pairs = self._pairs(c)
        pa = torch.tensor([p[0] for p in pairs], device=X.device)
        pb = torch.tensor([p[1] for p in pairs], device=X.device)
        yl = y.long()[:, None]
        Smask = (((yl == pa) | (yl == pb))[None] & (w > 0)[..., None]).to(torch.float32)
        Tsign = torch.where(yl == pa, 1.0, -1.0)  # [n, P]
        TS = Tsign * Smask  # [S, n, P]
        base = {"X": X, "gamma": gamma, "pairs_a": pa, "pairs_b": pb}
        if static.get("_nystrom"):
            return {**base, **self._fit_nystrom(X, C, Smask, Tsign, gamma, static)}
        K = self._kernel_of(X, X, gamma, static)
        Kb = _round_bf16(K) if static["kernel"] == "rbf" else K

        def qmatvec(V):  # [T, S, n, P], f32 sums of the bf16 Gram's products
            return TS * _per_split(Kb, _round_bf16(TS * V) if Kb is not K else TS * V)

        # each machine's 1/lambda_max: the operator depends on the split only
        eta = 1.0 / _power_lambda_max(lambda V: qmatvec(V[None])[0], X.shape[0], TS)
        hi = C[:, None, None, None] * Smask[None]
        A, steps = _fista_ascent(qmatvec, TS[None], Smask[None].expand_as(hi), hi, eta[None],
                                 _pg_steps(), 1e-6)
        # KKT intercepts over the free support vectors (0 < alpha < C) of
        # each machine, else over all its support vectors
        dual = A * TS
        F = _per_split(K, dual)
        Cl = C[:, None, None, None]
        free = Smask * (A > 1e-6 * Cl) * (A < Cl * (1.0 - 1e-6))
        anyv = Smask * (A > 1e-6 * Cl)
        use = torch.where(torch.sum(free, dim=2, keepdim=True) > 0.5, free, anyv)
        b = torch.sum(use * (Tsign - F), dim=2) / torch.clamp(torch.sum(use, dim=2), min=1e-6)
        return {**base, "dual": dual, "intercept": b, "dual_steps": steps, "F": F}

    def _fit_nystrom(self, X, C, Smask, Tsign, gamma, static):
        """Primal squared-hinge OvO machines on the Nyström features."""
        Z, landmarks, inv, lam_max = self._nystrom_Z(X, gamma, static)
        T, S, P = C.shape[0], Smask.shape[0], Smask.shape[2]
        L_est = (1.0 + 2.0 * C[:, None] * lam_max[None])[..., None, None]  # [T, G, 1, 1]
        Cl = C[:, None, None, None]
        st = Smask * Tsign  # [S, n, P]

        def grad(W):  # W [T, S, m + 1, P]
            margin = torch.clamp(1.0 - Tsign * _per_split(Z, W), min=0.0)
            return W - 2.0 * Cl * _per_split(Z.transpose(1, 2), st * margin)

        W0 = X.new_zeros((T, S, Z.shape[2], P))
        W = _nesterov_primal(grad, W0, L_est, _nystrom_steps())
        return {"W": W, "Z": Z, "landmarks": landmarks, "inv_sqrt": inv}

    def _pair_decisions(self, params, Xq, static):
        """``[T, S, nq, P]`` OvO decision values; > 0 votes pairs_a. The
        search path scores the rows it fitted on: there the fit's own
        products are the query's."""
        if "W" in params:
            return _per_split(self._query_features(params, Xq, static), params["W"])
        if Xq is params["X"]:
            F = params["F"]
        else:
            F = _per_split(self._kernel_of(Xq.to(torch.float32), params["X"], params["gamma"],
                                           static), params["dual"])
        return F + params["intercept"][:, :, None, :]

    def predict(self, params, X, static: Dict[str, Any]):
        """Labels ``[T, S, nq]`` by OvO votes, ties to the first class."""
        c = max(int(static["_n_classes"]), 2)
        dec = self._pair_decisions(params, X, static)
        vote_a = (dec > 0).to(torch.float32)
        votes = dec.new_zeros(dec.shape[:-1] + (c,))
        votes.index_add_(-1, params["pairs_a"], vote_a)
        votes.index_add_(-1, params["pairs_b"], 1.0 - vote_a)
        return torch.argmax(votes, dim=-1)

    def predict_margin(self, params, X, static: Dict[str, Any]):
        """Binary decision function, positive for class 1 (the one pair's
        value is positive for class 0)."""
        return -self._pair_decisions(params, X, static)[..., 0]

    def batched_scores(self, X, y, TW, EW, hyper, static):
        params = self.fit(X, y, TW, hyper, static)
        return self.evaluate(params, X, y, EW[None], static)


class SVRKernel(SVCKernel):
    name = "SVR"
    task = "regression"
    hyper_defaults = {"C": 1.0, "epsilon": 0.1}

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """One machine a lane (T trials x S splits): the dual in beta =
        alpha - alpha*, solved in the split form [alpha; alpha*] >= 0 with
        t = [s; -s] carrying sum(beta) = 0."""
        X = X.to(torch.float32)
        y = y.to(torch.float32)
        w = w.to(torch.float32)
        C = hyper["C"].to(torch.float32)
        eps = hyper["epsilon"].to(torch.float32)
        gamma = self._gamma(X, w, static)
        s = (w > 0).to(torch.float32)  # [S, n]
        base = {"X": X, "gamma": gamma}
        if static.get("_nystrom"):
            return {**base, **self._fit_nystrom(X, y, s, C, eps, gamma, static)}
        n = X.shape[0]
        K = self._kernel_of(X, X, gamma, static)
        Ks = K * (s[:, :, None] * s[:, None, :])  # [S, n, n]
        Ksb = _round_bf16(Ks) if static["kernel"] == "rbf" else Ks

        def qmatvec(V):  # V [T, S, 2n, 1]: [[K, -K], [-K, K]] @ V, K bf16
            Vb = _round_bf16(V) if Ksb is not Ks else V
            Ka, Kb_ = _per_split(Ksb, Vb[:, :, :n]), _per_split(Ksb, Vb[:, :, n:])
            return torch.cat([Ka - Kb_, Kb_ - Ka], dim=2)

        tcol = torch.cat([s, -s], dim=1)[..., None]  # [S, 2n, 1]
        eta = 1.0 / _power_lambda_max(lambda V: qmatvec(V[None])[0], 2 * n, tcol)
        Cl, el = C[:, None, None], eps[:, None, None]
        lin = torch.cat([(y - el) * s, (-y - el) * s], dim=2)[..., None]  # [T, S, 2n, 1]
        box = torch.cat([Cl * s, Cl * s], dim=2)[..., None]
        a, steps = _fista_ascent(qmatvec, tcol[None], lin, box, eta[None], _pg_steps(), 1e-6)
        a = a[..., 0]
        up, dn = a[..., :n], a[..., n:]
        beta = (up - dn) * s
        f = _per_split(Ks, beta[..., None])[..., 0]
        free_up = s * (up > 1e-6 * Cl) * (up < Cl * (1.0 - 1e-6))
        free_dn = s * (dn > 1e-6 * Cl) * (dn < Cl * (1.0 - 1e-6))
        num = (torch.sum(free_up * (y - f - el), dim=-1)
               + torch.sum(free_dn * (y - f + el), dim=-1))
        den = torch.sum(free_up, dim=-1) + torch.sum(free_dn, dim=-1)
        b = torch.where(den > 0.5, num / torch.clamp(den, min=1e-6),
                        torch.sum(s * (y - f), dim=-1) / torch.clamp(torch.sum(s, dim=-1),
                                                                   min=1e-6))
        return {**base, "dual": beta, "intercept": b, "dual_steps": steps, "K": K}

    def _fit_nystrom(self, X, y, s, C, eps, gamma, static):
        """Primal huberised epsilon-insensitive regression on the Nyström
        features: l(r) = max(0, |r| - eps)^2."""
        Z, landmarks, inv, lam_max = self._nystrom_Z(X, gamma, static)
        T, S = C.shape[0], s.shape[0]
        L_est = (1.0 + 2.0 * C[:, None] * lam_max[None])[..., None, None]
        Cl, el = C[:, None, None, None], eps[:, None, None, None]
        sl = s[..., None]

        def grad(W):  # W [T, S, m + 1, 1]
            r = _per_split(Z, W) - y[:, None]
            dl = 2.0 * torch.sign(r) * torch.clamp(torch.abs(r) - el, min=0.0)
            return W + Cl * _per_split(Z.transpose(1, 2), sl * dl)

        W = _nesterov_primal(grad, X.new_zeros((T, S, Z.shape[2], 1)), L_est, _nystrom_steps())
        return {"W": W, "Z": Z, "landmarks": landmarks, "inv_sqrt": inv}

    @staticmethod
    def _lane_w(v):
        """SVR's lane: duals ``[n]``; Nyström weights ``[m + 1, 1]`` as the
        JAX ``[m + 1]``."""
        return to_host(v.reshape(v.shape[0]))

    @staticmethod
    def _unlane_w(a):
        return a  # the duals, ``[n]``; the Nyström weights are reshaped below

    def params_from_artifact(self, np_params, device):
        p = super().params_from_artifact(np_params, device)
        if "W" in p:
            p["W"] = p["W"][..., None]  # [1, 1, m + 1, 1]
        return p

    def predict(self, params, X, static: Dict[str, Any]):
        """Predictions ``[T, S, nq]``."""
        if "W" in params:
            return _per_split(self._query_features(params, X, static), params["W"])[..., 0]
        Kq = params["K"] if X is params["X"] else self._kernel_of(
            X.to(torch.float32), params["X"], params["gamma"], static)
        return _per_split(Kq, params["dual"][..., None])[..., 0] + params["intercept"][..., None]
