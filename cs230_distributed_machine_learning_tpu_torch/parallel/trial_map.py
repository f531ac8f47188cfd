"""Trial execution engine: batched fits of whole trial buckets on one device.

Port of the main-path subset of the JAX package's ``parallel/trial_map.py``
(``run_trials`` / ``_run_trials_impl`` / ``_postprocess``). One dispatch
runs a whole bucket chunk of trials:

    every (trial, split) lane at once — holdout fit + K CV folds
      x T trials with their hyperparameters as [T] tensors

Trials are bucketed by static config. Per bucket, the first that applies:

- a kernel with a chunked-fit protocol (``chunked_plan``: tree ensembles,
  KNN) whose plan splits the fit runs ``_run_chunked``: init, then n_chunks
  steps carrying an accumulator state, then eval;
- a packed path (``build_batched_fn``: the LogReg CUDA-kernel fit) runs in
  chunks rounded up to the kernel's trial block and capped at its chunk
  cap;
- any other bucket runs the kernel's ``batched_scores``.

``fit_single`` refits one configuration on one split, for the winner's
artifact (runtime/artifacts.py).

The first and the last run in trial chunks bounded by device memory. A
kernel with ``prepare_data`` (tree binning) stages its prepared forms once
per bucket configuration, cached on the dataset. Results stay on the device
until every chunk has been dispatched, then come back to the host once per
output leaf.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.base import ModelKernel, TrialData
from ..ops.folds import SplitPlan
from ..ops.metrics import validate_scoring
from .mesh import pad_to_multiple


@dataclasses.dataclass
class TrialRunResult:
    """Per-trial metrics in submission order, plus batch-level timing."""

    trial_metrics: List[Dict[str, Any]]
    #: wall seconds from the first dispatch to the last result on the host
    run_time_s: float


def _device_memory_mb(device: torch.device) -> float:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 1e6
    return 8_000.0


def _memory_chunk_cap(kernel, n, d, static, n_splits, device) -> int:
    """Trials per generic dispatch bounded by device memory: each trial
    holds ~memory_estimate_mb per split at once."""
    per_trial_mb = max(kernel.memory_estimate_mb(n, d, static), 0.5) * max(n_splits, 1)
    return max(1, int(0.5 * _device_memory_mb(device) / per_trial_mb))


def run_trials(
    kernel: ModelKernel,
    data: TrialData,
    plan: SplitPlan,
    param_dicts: Sequence[Dict[str, Any]],
    *,
    device: torch.device,
    max_trials_per_batch: int = 256,
    scoring: Optional[str] = None,
) -> TrialRunResult:
    """Run all trials (one per param dict) on ``device``, bucketing by
    static config. ``scoring`` None keeps the task's default metric; a
    scorer name rides each bucket's static as ``_scoring`` and keeps the
    bucket off the packed and fused paths, which score by the default
    metric only (as in the reference)."""
    validate_scoring(scoring, kernel.task, data.n_classes, kernel)
    n, d = data.X.shape
    results: List[Optional[Dict[str, Any]]] = [None] * len(param_dicts)

    buckets: Dict[Any, List[int]] = {}
    hypers: List[Dict[str, float]] = []
    for i, params in enumerate(param_dicts):
        static_key, hyper = kernel.canonicalize(params)
        hypers.append(hyper)
        buckets.setdefault(static_key, []).append(i)

    y = torch.as_tensor(np.asarray(data.y), device=device)
    TW = torch.as_tensor(plan.train_w, device=device)
    EW = torch.as_tensor(plan.eval_w, device=device)
    X_raw = None
    staged: Dict[int, Dict[str, torch.Tensor]] = {}  # prepared forms on the device

    pending: List[Any] = []
    t0 = time.perf_counter()
    for static_key, idxs in buckets.items():
        static = kernel.static_from_key(static_key)
        if hasattr(kernel, "resolve_static"):
            static = kernel.resolve_static(static, n, d, data.n_classes)
        static["_n_classes"] = data.n_classes
        if scoring is not None:
            static["_scoring"] = scoring
        if hasattr(kernel, "bucket_static"):
            static = kernel.bucket_static(static, [hypers[i] for i in idxs])
        hyper_names = sorted(hypers[idxs[0]].keys())

        prepared = None
        if hasattr(kernel, "prepare_data"):
            prepared = _prepared_data(kernel, data, static)
            if id(prepared) not in staged:
                staged[id(prepared)] = {k: torch.as_tensor(v, device=device)
                                        for k, v in prepared.items()}
            X = staged[id(prepared)]
        else:
            if X_raw is None:
                X_raw = torch.as_tensor(np.asarray(data.X, np.float32), device=device)
            X = X_raw

        chunk_plan = None
        if hasattr(kernel, "chunked_plan"):
            chunk_plan = kernel.chunked_plan(static, n, d, data.n_classes, plan.n_splits,
                                             prepared=prepared, device=device)
        if chunk_plan:
            pending.extend(_run_chunked(kernel, static, X, y, TW, EW, hypers, idxs,
                                        hyper_names, plan, chunk_plan, d, device))
            continue

        # kernels with a packed path (the LogReg kernel fit) take over the
        # whole chunk, with their own (larger) chunk geometry
        fn = None
        if hasattr(kernel, "build_batched_fn") and scoring is None:
            Tw = kernel.batched_trial_multiple
            chunk = max(Tw, min(kernel.batched_chunk_cap, pad_to_multiple(len(idxs), Tw)))
            fn = kernel.build_batched_fn(
                static=static, n=n, d=d, n_classes=data.n_classes,
                n_splits=plan.n_splits, chunk=chunk, device=device,
            )
        if fn is None:
            mem_cap = _memory_chunk_cap(kernel, n, d, static, plan.n_splits, device)
            chunk = max(1, min(max_trials_per_batch, mem_cap, len(idxs)))

            def fn(X, y, TW, EW, hyper, static=static):
                return kernel.batched_scores(X, y, TW, EW, hyper, static)

        for start in range(0, len(idxs), chunk):
            batch_idx = idxs[start : start + chunk]
            hyper_arg = _hyper_batch(hypers, batch_idx, hyper_names, chunk, device)
            pending.append((fn(X, y, TW, EW, hyper_arg), batch_idx))

    for out, batch_idx in pending:
        host = {k: v.cpu().numpy() for k, v in out.items()}
        for j, gi in enumerate(batch_idx):
            results[gi] = _postprocess(host, j, plan, kernel.task, scoring)
    return TrialRunResult(
        trial_metrics=[r for r in results if r is not None],
        run_time_s=time.perf_counter() - t0,
    )


def fit_single(kernel: ModelKernel, data: TrialData, plan: SplitPlan,
               params: Dict[str, Any], split: int = 0, *, device: torch.device):
    """Fit one configuration on one split's training rows (default: split
    0, the holdout's) on ``device``; returns (the fitted params in the JAX
    artifact layout, as host numpy; the resolved static). Counterpart of
    the JAX ``fit_single``: the winner's artifact is refitted once, after
    the search (the reference pickled every trial's model). A kernel with
    a chunked plan and ``fit_chunk`` (the tree ensembles) fits its trees
    or stages in the plan's chunks, as the search does; any other kernel
    runs its ``fit`` at one lane."""
    n, d = data.X.shape
    static_key, hyper = kernel.canonicalize(params)
    static = kernel.static_from_key(static_key)
    if hasattr(kernel, "resolve_static"):
        static = kernel.resolve_static(static, n, d, data.n_classes)
    static["_n_classes"] = data.n_classes
    if hasattr(kernel, "bucket_static"):  # caps masked-out solver steps only
        static = kernel.bucket_static(static, [hyper])

    prepared = None
    if hasattr(kernel, "prepare_data"):
        prepared = _prepared_data(kernel, data, static)
        X = {k: torch.as_tensor(v, device=device) for k, v in prepared.items()}
    else:
        X = torch.as_tensor(np.asarray(data.X, np.float32), device=device)
    y = torch.as_tensor(np.asarray(data.y), device=device)
    w = torch.as_tensor(plan.train_w[split:split + 1], device=device)  # [1, n]
    hyper_arg = {k: torch.tensor([v], dtype=torch.float32, device=device)
                 for k, v in hyper.items()}

    chunk_plan = None
    if hasattr(kernel, "chunked_plan") and hasattr(kernel, "fit_chunk"):
        chunk_plan = kernel.chunked_plan(static, n, d, data.n_classes, 1,
                                         prepared=prepared, device=device)
    if chunk_plan:
        carry = kernel.chunk_init(X, y, w, hyper_arg, static)
        units: List[Any] = []
        for ci in range(int(chunk_plan["n_chunks"])):
            carry, part = kernel.fit_chunk(X, y, w, hyper_arg, static, ci, carry, chunk_plan)
            units.extend(part)
        units = units[: int(static.get("n_estimators", 100))]
        fitted = kernel.assemble_artifact(units, X, hyper_arg, static, y, w)
    else:
        fitted = kernel.fit(X, y, w, hyper_arg, static)
    return kernel.artifact_params(fitted, lane=0), static


def _hyper_batch(hypers, batch_idx, hyper_names, chunk, device) -> Dict[str, torch.Tensor]:
    """``[chunk]`` tensors of the chunk's hypers, padded with the last
    trial's values (padded lanes are computed and dropped). A kernel with
    no traced hypers gets a ``_pad`` of zeros, which carries the chunk's
    trial count."""
    if not hyper_names:
        return {"_pad": torch.zeros((chunk,), dtype=torch.float32, device=device)}
    hyper_batch = {
        k: np.full((chunk,), hypers[batch_idx[-1]][k], np.float32) for k in hyper_names
    }
    for j, gi in enumerate(batch_idx):
        for k in hyper_names:
            hyper_batch[k][j] = hypers[gi][k]
    return {k: torch.as_tensor(v, device=device) for k, v in hyper_batch.items()}


def _prepared_data(kernel, data: TrialData, static: Dict[str, Any]):
    """Bucket-level ``prepare_data`` (tree binning), cached on the TrialData
    so that every bucket and every job over a cached dataset reuses it.
    Keyed by the kernel and the resolved static entries prepare_data reads
    (``kernel.prepared_key``)."""
    cache = data.__dict__.get("_prepared_cache")
    if cache is None:
        cache = {}
        object.__setattr__(data, "_prepared_cache", cache)
    key = (kernel.name, kernel.prepared_key(static))
    if key not in cache:
        cache[key] = kernel.prepare_data(np.asarray(data.X), static)
    return cache[key]


def _run_chunked(kernel, static, X, y, TW, EW, hypers, idxs, hyper_names, plan,
                 chunk_plan, d, device) -> List[Any]:
    """One bucket through the kernel's chunked-fit protocol, on one device:
    per trial chunk, ``chunk_init`` -> n_chunks x ``chunk_step`` ->
    ``chunk_eval`` over all (trial, split) lanes; the state between steps
    (a forest's summed leaf predictions, a KNN's predicted query rows)
    never leaves the device. ``d`` is the table's feature count. The trial
    chunk is bounded by the state's memory, the kernel's working set and
    64 trials (``trial_map.py:1707`` there). Returns the pending
    (outputs, trial indices) pairs."""
    n, n_splits = y.shape[0], int(plan.n_splits)
    n_classes = int(static.get("_n_classes", 0))
    state_mb = 4.0 * n * max(n_classes, 1) * n_splits / 1e6
    mem_cap = _memory_chunk_cap(kernel, n, d, static, n_splits, device)
    chunk = max(1, min(len(idxs), mem_cap,
                       int(0.25 * _device_memory_mb(device) / max(state_mb, 1.0)), 64))
    out = []
    for start in range(0, len(idxs), chunk):
        batch_idx = idxs[start : start + chunk]
        hyper = _hyper_batch(hypers, batch_idx, hyper_names, chunk, device)
        # lane = trial * S + split: the fold masks repeated per trial
        TWl = TW.repeat(chunk, 1)
        hyper_l = {k: v.repeat_interleave(n_splits) for k, v in hyper.items()}
        state = kernel.chunk_init(X, y, TWl, hyper_l, static)
        for ci in range(int(chunk_plan["n_chunks"])):
            state = kernel.chunk_step(X, y, TWl, hyper_l, static, ci, state, chunk_plan)
        res = kernel.chunk_eval(X, y, EW.repeat(chunk, 1), hyper_l, static, state)
        out.append(({k: v.reshape(chunk, n_splits, *v.shape[1:]) for k, v in res.items()},
                    batch_idx))
    return out


def _postprocess(out: Dict[str, np.ndarray], j: int, plan: SplitPlan,
                 task: str, scoring: Optional[str] = None) -> Dict[str, Any]:
    """Split 0 = holdout test metrics; splits 1..K = CV fold scores.
    mean_cv_score is the trial-ranking key. With a scorer, the holdout
    score is reported under its name (and ``"scoring"`` names it)."""
    metrics: Dict[str, Any] = {}
    score = float(out["score"][j, 0])
    if scoring is not None:
        metrics[scoring] = score
        metrics["scoring"] = scoring
    elif task == "classification":
        metrics["accuracy"] = score
    elif task == "transform":
        metrics["score"] = score
    else:
        metrics["r2_score"] = score
    if task == "regression" and "mse" in out:
        metrics["mse"] = float(out["mse"][j, 0])
    if plan.n_folds >= 2:
        cv = out["score"][j, 1:]
        metrics["cv_scores"] = [float(v) for v in cv]
        metrics["mean_cv_score"] = float(np.mean(cv))
    else:
        metrics["mean_cv_score"] = score
    # a diverged trial (NaN/inf score) must rank last, not poison the sort
    if not np.isfinite(metrics["mean_cv_score"]):
        metrics["mean_cv_score"] = float("-inf")
        metrics["diverged"] = True
    channels = {
        k[len("curve_"):]: out[k][j]
        for k in out
        if k.startswith("curve_") and k not in ("curve_stride", "curve_steps")
    }
    if channels:
        from ..obs.curves import build_curve_record

        stride = int(np.asarray(out["curve_stride"])[j].flat[0])
        steps = int(np.asarray(out["curve_steps"])[j].flat[0])
        metrics["curve"] = build_curve_record(
            channels, stride, steps, tail=np.asarray(out["score"][j]).reshape(-1)
        )
    return metrics
