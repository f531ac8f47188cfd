"""K-nearest-neighbours kernels: KNeighborsClassifier and KNeighborsRegressor.

Port of the JAX package's ``models/knn.py``. The semantics are the
reference's:

- Euclidean distance (minkowski p=2) through the expansion ||q||^2 +
  ||x||^2 - 2 q.x, queries in blocks and training rows in tiles, so the
  ``[nq, n]`` distance matrix never exists;
- "fitting" stores the training table and the split mask: every row stays
  and the split is the mask, so the K+1 fits of a trial are free;
- ``n_neighbors`` and ``weights`` are static (one bucket each), k is
  clamped to n;
- distance weighting is 1/d, and a query with an exact match (d = 0) is
  voted on by its exact matches only; classification ties go to the
  smallest label (the first maximum).

Every function works on an explicit lane axis L = trials x splits (the JAX
package vmaps instead): split weights ``[L, n]``, neighbours ``[L, nq, k]``,
predictions ``[L, nq]``.

Two neighbour searches, as in the reference:

- at n >= 150,000 training rows on the card (or under
  ``CS230_FORCE_PACKED=1`` on any device, where the CPU runs its plain
  version), kernel B6 (``ops/cuda_knn.py``), whose empty slots are
  ``(3.4e38, -1)`` (the TPU kernel's carry its first slot's index);
- otherwise the generic streaming top-k: k min-extractions with the first
  argmin for k <= 16, a stable sort of ``[best, tile]`` above (the
  reference's ``lax.top_k`` prefers the lower position on ties;
  ``torch.topk`` promises nothing about them), empty slots ``(big, 0)``.

A slot is empty only where a lane has fewer than k masked-in rows; an
index of -1 reads the last row (``y[-1]``), as it does in JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import cuda_knn
from .base import ModelKernel, score_lanes, to_device, to_host
from .logistic import _force_packed

_QUERY_BLOCK = 1024
_TRAIN_TILE = 16384
#: neighbour counts at or below this take k min-extractions in place of a
#: sort of the merged tile (the reference's crossover)
_SMALL_K = 16
#: training rows from which the card takes kernel B6
_PALLAS_MIN_N = 150_000
_BIG = 3.4e38


def _use_pallas(n: int, device: Optional[torch.device]) -> bool:
    """Kernel B6 for n >= 150,000 training rows on a CUDA device (the
    reference's gate asks for a non-CPU backend), or anywhere under
    ``CS230_FORCE_PACKED=1``."""
    if _force_packed():
        return True
    return n >= _PALLAS_MIN_N and device is not None and torch.device(device).type == "cuda"


def _first_min_extractions(cat_d, cat_i, k: int):
    """The reference's small-k merge: k rounds of (first argmin, take,
    retire the taken column to big)."""
    cur = cat_d
    ds, is_ = [], []
    for _ in range(k):
        j = torch.argmin(cur, dim=-1, keepdim=True)
        ds.append(torch.gather(cur, -1, j))
        is_.append(torch.gather(cat_i, -1, j))
        cur = cur.scatter(-1, j, _BIG)
    return torch.cat(ds, dim=-1), torch.cat(is_, dim=-1)


class _KNNBase(ModelKernel):
    hyper_defaults: Dict[str, float] = {}
    static_defaults = {"n_neighbors": 5, "weights": "uniform", "p": 2}

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        if int(static.get("p", 2)) != 2:
            raise ValueError("KNN: only p=2 (euclidean) is supported")
        if static.get("weights") not in ("uniform", "distance"):
            raise ValueError(f"KNN: unsupported weights={static.get('weights')!r}")
        k = int(static.get("n_neighbors", 5))
        return {**static, "n_neighbors": min(k, n)}

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """The whole table and the lanes' split weights ``w [L, n]``."""
        return {"X": X.to(torch.float32), "y": y, "w": w.to(torch.float32)}

    def artifact_params(self, params, lane: int = 0):
        """The JAX layout ``{X, y, w}``: the table and targets, the lane's
        split weights ``[n]``."""
        return {"X": to_host(params["X"]), "y": to_host(params["y"]),
                "w": to_host(params["w"][lane])}

    def params_from_artifact(self, np_params, device):
        return {"X": to_device(np_params["X"], device), "y": to_device(np_params["y"], device),
                "w": to_device(np_params["w"], device)[None]}

    def _neighbors(self, params, Q, static):
        """Per lane and query: (top-k distances^2, top-k training rows),
        ``[L, nq, k]`` each."""
        k = int(static["n_neighbors"])
        Xt, W = params["X"], params["w"]
        if _use_pallas(Xt.shape[0], Xt.device):
            return cuda_knn.knn_topk(Q.contiguous(), Xt.contiguous(), W.contiguous(), k)
        L, n = W.shape
        dev = Xt.device
        # train side padded to tile multiples; padded rows carry w=0, so
        # they are masked to big
        T = min(_TRAIN_TILE, max(n, 1))
        n_tp = -(-n // T) * T
        Xtp = torch.nn.functional.pad(Xt, (0, 0, 0, n_tp - n))
        Wp = torch.nn.functional.pad(W, (0, n_tp - n))
        sq_tp = (Xtp * Xtp).sum(dim=1)
        nq = Q.shape[0]
        Qp = torch.nn.functional.pad(Q, (0, 0, 0, (-nq) % _QUERY_BLOCK))
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        out_d, out_i = [], []
        for b0 in range(0, Qp.shape[0], _QUERY_BLOCK):
            qb = Qp[b0:b0 + _QUERY_BLOCK]
            sq_q = (qb * qb).sum(dim=1, keepdim=True)
            best_d = torch.full((L, _QUERY_BLOCK, k), _BIG, dtype=torch.float32, device=dev)
            best_i = torch.zeros((L, _QUERY_BLOCK, k), dtype=torch.int32, device=dev)
            # earlier tiles sit first in the merge, so equal distances keep
            # the smaller training index (sklearn's order)
            for t0 in range(0, n_tp, T):
                d2 = sq_q + sq_tp[None, t0:t0 + T] - 2.0 * (qb @ Xtp[t0:t0 + T].T)
                d2 = torch.where(Wp[:, None, t0:t0 + T] > 0, torch.maximum(d2, zero)[None], _BIG)
                cols = torch.arange(t0, t0 + T, dtype=torch.int32, device=dev)
                cat_d = torch.cat([best_d, d2], dim=2)
                cat_i = torch.cat([best_i, cols.expand(L, _QUERY_BLOCK, T)], dim=2)
                if k <= _SMALL_K:
                    best_d, best_i = _first_min_extractions(cat_d, cat_i, k)
                else:
                    sd, order = torch.sort(cat_d, dim=2, stable=True)
                    best_d = sd[..., :k]
                    best_i = torch.gather(cat_i, 2, order[..., :k])
            out_d.append(best_d)
            out_i.append(best_i)
        return torch.cat(out_d, dim=1)[:, :nq], torch.cat(out_i, dim=1)[:, :nq]

    @staticmethod
    def _vote_weights(d2, static):
        if static.get("weights") == "distance":
            d = torch.sqrt(torch.clamp(d2, min=0.0))
            inv = 1.0 / torch.clamp(d, min=1e-12)
            # sklearn: if any neighbour matches exactly, only exact matches vote
            exact = d <= 1e-12
            return torch.where(exact.any(dim=-1, keepdim=True), exact.to(torch.float32), inv)
        return torch.ones_like(d2)

    def evaluate(self, params, X, y, w, static: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Per-lane score on the rows ``w [L, n]`` selects, by the job's
        scorer."""
        return self._score(static, y, self.predict(params, X, static), w)

    def _score(self, static, y, pred, w):
        """The job's score of the predictions ``[L, n]``. KNN exposes
        neither a margin nor probabilities, as in the reference: the label
        scorers only (``validate_scoring`` refuses the others)."""
        if self.task == "classification":
            return score_lanes(self, static, y, w, predict=lambda: pred.long())
        return score_lanes(self, static, y, w, predict=lambda: pred.to(torch.float32))

    def batched_scores(self, X, y, TW, EW, hyper, static):
        """``[T, S]`` scores: every (trial, split) pair is one lane (lane =
        trial * S + split) of one ``fit`` and one ``evaluate``. KNN has no
        traced hypers; ``hyper`` carries only the trial count."""
        T, S = next(iter(hyper.values())).shape[0], TW.shape[0]
        fitted = self.fit(X, y, TW.repeat(T, 1), {}, static)
        out = self.evaluate(fitted, X, y, EW.repeat(T, 1), static)
        return {k: v.reshape(T, S) for k, v in out.items()}

    def memory_estimate_mb(self, n, d, static):
        # tiled top-k workspace: [QUERY_BLOCK, TRAIN_TILE] per split plus
        # the shared [n, d] table
        return max(1.0, 4.0 * (n * d + 3 * _QUERY_BLOCK * _TRAIN_TILE) / 1e6)

    def macs_estimate(self, n, d, static):
        """Scoring-time n x n distance sweep dominates (fit is free)."""
        return float(n) * n * max(d, 1)

    # ---- chunked-fit protocol (parallel/trial_map.py::_run_chunked) ----
    # The cost is the query x training-row sweep at scoring time. Chunks
    # split the QUERY rows: each step predicts one row range of every lane
    # into the state, so each dispatch's work stays bounded.

    def chunked_plan(self, static, n, d, n_classes, n_splits, prepared=None, device=None):
        """The reference's plan (``models/knn.py:190``): a budget of 1.6e12
        MACs a dispatch on the min-extraction path, 2.5e11 otherwise, gated
        like ``_neighbors`` but on a split's training rows ((S-1)/S of n)
        and on ``device``; ``CS230_KNN_CHUNK_MACS`` overrides it."""
        train_rows = n if n_splits <= 1 else (n * (n_splits - 1)) // n_splits
        small_path = (int(static.get("n_neighbors", 5)) <= _SMALL_K
                      and not _use_pallas(train_rows, device))
        default = 1.6e12 if small_path else 2.5e11
        chunk_macs = float(os.environ.get("CS230_KNN_CHUNK_MACS", default))
        macs = float(max(n_splits, 1)) * n * n * max(d, 1)
        n_chunks = int(np.ceil(macs / chunk_macs))
        if n_chunks <= 1:
            return None
        q = int(np.ceil(n / n_chunks))
        q = max(_QUERY_BLOCK, -(-q // _QUERY_BLOCK) * _QUERY_BLOCK)
        n_chunks = int(np.ceil(n / q))
        if n_chunks <= 1:  # rounding collapsed it: monolithic is cheaper
            return None
        return {"n_chunks": n_chunks, "rows_per_chunk": q}

    def chunk_init(self, X, y, w, hyper, static):
        """``[L, n]`` predictions: labels (int32) or targets (f32)."""
        dtype = torch.int32 if self.task == "classification" else torch.float32
        return torch.zeros((w.shape[0], X.shape[0]), dtype=dtype, device=w.device)

    def chunk_step(self, X, y, w, hyper, static, chunk_idx, state, plan):
        """Predict chunk ``chunk_idx``'s query rows for every lane into
        ``state [L, n]``, in place. The start is clamped, as the
        reference's dynamic_slice clamps it, so the last (ragged) chunk
        predicts a few rows again, to the same values."""
        Xa = X.to(torch.float32)
        q = plan["rows_per_chunk"]
        n = Xa.shape[0]
        start = min(chunk_idx * q, max(n - q, 0))
        size = min(q, n)
        params = self.fit(Xa, y, w, hyper, static)
        preds = self.predict(params, Xa[start:start + size], static)
        state[:, start:start + size] = preds.to(state.dtype)
        return state

    def chunk_eval(self, X, y, w_eval, hyper, static, state):
        return self._score(static, y, state, w_eval)


class KNNClassifierKernel(_KNNBase):
    name = "KNeighborsClassifier"
    task = "classification"

    def predict(self, params, X, static: Dict[str, Any]):
        """``[L, nq]`` labels: the class with the largest vote weight, the
        smallest label on ties."""
        c = max(int(static["_n_classes"]), 2)
        d2, idx = self._neighbors(params, X.to(torch.float32), static)
        labels = params["y"].long()[idx.long()]  # [L, nq, k]
        votes = self._vote_weights(d2, static)
        onehot = torch.nn.functional.one_hot(labels, c).to(torch.float32)
        counts = (onehot * votes[..., None]).sum(dim=2)
        return torch.argmax(counts, dim=-1).to(torch.int32)


class KNNRegressorKernel(_KNNBase):
    name = "KNeighborsRegressor"
    task = "regression"

    def predict(self, params, X, static: Dict[str, Any]):
        """``[L, nq]`` vote-weighted mean targets."""
        d2, idx = self._neighbors(params, X.to(torch.float32), static)
        targets = params["y"].to(torch.float32)[idx.long()]
        votes = self._vote_weights(d2, static)
        return (targets * votes).sum(dim=2) / torch.clamp(votes.sum(dim=2), min=1e-12)
