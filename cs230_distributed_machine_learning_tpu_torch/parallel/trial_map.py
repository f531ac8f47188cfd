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
artifact (runtime/artifacts.py). ``run_trials_callable`` is the host-side
path of a callable ``scoring``: ``fit_single`` on the device per (trial,
split), the scikit-learn export, the user's scorer on the host.

The first and the last run in trial chunks bounded by device memory. A
kernel with ``prepare_data`` (tree binning) prepares its forms once per
bucket configuration, cached on the dataset. Results stay on the device
until every chunk has been dispatched, then come back to the host once per
output leaf.

Staging (``_Staging``): the dataset (raw, or its prepared forms), the fold
tensors and the packed LogReg path's precomputes
(``batched_staged_extras``) go through the process-global stage cache
(data/stage_cache.py), keyed by the dataset's content fingerprint and the
device, so the jobs of a process share one upload; a run pins what it
touches while it runs. ``CS230_STAGE_CACHE=0`` stages per call instead.

Out-of-core streaming (``_run_streamed``, data/streaming.py): decided
before any X staging, a single-device, unchunked, unscored bucket whose
kernel has ``stream_scores`` and whose staged form crowds the stage budget
(``CS230_STREAM``) never uploads the whole matrix: the kernel accumulates
over row blocks instead.
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
    #: wall seconds from the first dispatch to the last result on the host,
    #: less the streamed buckets' waits for their blocks
    run_time_s: float


def _device_sig(device: torch.device) -> tuple:
    """The device's identity in stage-cache keys: (type, index)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device() if device.type == "cuda" else 0
    return (device.type, int(index))


class _Staging:
    """Device copies of one run's job-invariant tensors (the dataset, its
    prepared forms, the fold tensors, the packed path's precomputes).

    Default: the process-global stage cache (data/stage_cache.py), keyed
    ``(dataset_fingerprint, (device.type, device.index)) + subkey`` with
    single-flight uploads and refcounted LRU eviction, so every job of a
    process over one dataset stages it once. ``CS230_STAGE_CACHE=0``: made
    once per call, as before the cache."""

    def __init__(self, data: TrialData, device: torch.device):
        from ..data import stage_cache

        self.data = data
        self.device = device
        self._sc = stage_cache if stage_cache.enabled() else None
        self._local: Dict[Any, Any] = {}
        self._folds: Optional[tuple] = None

    def get(self, key: tuple, make, cache: bool = True):
        if self._sc is None or not cache:
            if key not in self._local:
                self._local[key] = make()
            return self._local[key]
        gkey = (self._sc.dataset_fingerprint(self.data), _device_sig(self.device)) + tuple(key)
        return self._sc.STAGE_CACHE.get_or_stage(gkey, make)[0]

    def get_signed(self, signature, key: tuple, make):
        """A fold-plan-derived entry, keyed ``key[0], signature, *key[1:]``:
        cached when the plan has a signature to key on, else made for this
        call alone."""
        return self.get(key[:1] + (signature,) + key[1:], make, cache=signature is not None)

    def folds(self, plan: SplitPlan):
        """(y [n], TW [S, n], EW [S, n]) on the device."""
        if self._folds is None:
            dev = self.device
            self._folds = self.get_signed(plan.signature, ("folds",), lambda: (
                torch.as_tensor(np.asarray(self.data.y), device=dev),
                torch.as_tensor(plan.train_w, device=dev),
                torch.as_tensor(plan.eval_w, device=dev)))
        return self._folds

    def X(self, kernel, static, prepared):
        """The bucket's X: its prepared forms (a dict) or the raw f32 matrix."""
        dev = self.device
        if prepared is not None:
            return self.get(("prepared", kernel.name, kernel.prepared_key(static)),
                            lambda: {k: torch.as_tensor(v, device=dev)
                                     for k, v in prepared.items()})
        return self.get(("X",), lambda: torch.as_tensor(
            np.asarray(self.data.X, np.float32), device=dev))


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
    bucket off the packed, fused and streamed paths, which score by the
    default metric only (as in the reference). The stage-cache entries the
    run touches are pinned while it runs."""
    from ..data import stage_cache

    token = stage_cache.STAGE_CACHE.pin_begin() if stage_cache.enabled() else None
    try:
        return _run_trials_impl(kernel, data, plan, param_dicts, device=device,
                                max_trials_per_batch=max_trials_per_batch, scoring=scoring)
    finally:
        if token is not None:
            stage_cache.STAGE_CACHE.pin_end(token)


def _run_trials_impl(kernel, data, plan, param_dicts, *, device, max_trials_per_batch,
                     scoring) -> TrialRunResult:
    validate_scoring(scoring, kernel.task, data.n_classes, kernel)
    n, d = data.X.shape
    results: List[Optional[Dict[str, Any]]] = [None] * len(param_dicts)

    buckets: Dict[Any, List[int]] = {}
    hypers: List[Dict[str, float]] = []
    for i, params in enumerate(param_dicts):
        static_key, hyper = kernel.canonicalize(params)
        hypers.append(hyper)
        buckets.setdefault(static_key, []).append(i)

    staging = _Staging(data, device)
    pending: List[Any] = []
    stream_wait = 0.0
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

        prepared = _prepared_data(kernel, data, static) if hasattr(kernel, "prepare_data") else None
        chunk_plan = None
        if hasattr(kernel, "chunked_plan"):
            chunk_plan = kernel.chunked_plan(static, n, d, data.n_classes, plan.n_splits,
                                             prepared=prepared, device=device)

        # out-of-core streaming, decided before any X staging so that the
        # oversized single-shot upload never happens
        if not chunk_plan and scoring is None and hasattr(kernel, "stream_scores"):
            from ..data.stage_cache import _tree_nbytes
            from ..data.streaming import should_stream, stream_mode

            X_host = prepared if prepared is not None else np.asarray(data.X, np.float32)
            if (stream_mode() != "off" and kernel.stream_applicable(static, n, d)
                    and should_stream(_tree_nbytes(X_host))):
                out, waited = _run_streamed(kernel, static, X_host, hypers, idxs, hyper_names,
                                            plan, staging, max_trials_per_batch)
                pending.extend(out)
                stream_wait += waited
                continue

        X = staging.X(kernel, static, prepared)
        y, TW, EW = staging.folds(plan)
        if chunk_plan:
            pending.extend(_run_chunked(kernel, static, X, y, TW, EW, hypers, idxs,
                                        hyper_names, plan, chunk_plan, d, device))
            continue

        # kernels with a packed path (the LogReg kernel fit) take over the
        # whole chunk, with their own (larger) chunk geometry
        fn = None
        extras: Dict[str, Any] = {}
        if hasattr(kernel, "build_batched_fn") and scoring is None:
            Tw = kernel.batched_trial_multiple
            chunk = max(Tw, min(kernel.batched_chunk_cap, pad_to_multiple(len(idxs), Tw)))
            fn = kernel.build_batched_fn(
                static=static, n=n, d=d, n_classes=data.n_classes,
                n_splits=plan.n_splits, chunk=chunk, device=device,
            )
        if fn is not None and hasattr(kernel, "batched_staged_extras"):
            # dispatch-invariant forms staged once per (dataset, device,
            # subkey) and merged into every dispatch's hypers
            specs = kernel.batched_staged_extras(
                static=static, n=n, d=d, n_classes=data.n_classes, n_splits=plan.n_splits,
                fold_signature=plan.signature, device=device)
            ctx = {"X": X, "y": y, "TW": TW, "EW": EW}
            for name in sorted(specs):
                subkey, make = specs[name]
                if subkey is None:  # nothing stable to key on: made once a bucket
                    extras[name] = make(ctx)
                else:
                    extras[name] = staging.get(("batched_extra", kernel.name, name) + tuple(subkey),
                                               lambda m=make: m(ctx))
        if fn is None:
            mem_cap = _memory_chunk_cap(kernel, n, d, static, plan.n_splits, device)
            chunk = max(1, min(max_trials_per_batch, mem_cap, len(idxs)))

            def fn(X, y, TW, EW, hyper, static=static):
                return kernel.batched_scores(X, y, TW, EW, hyper, static)

        for start in range(0, len(idxs), chunk):
            batch_idx = idxs[start : start + chunk]
            hyper_arg = _hyper_batch(hypers, batch_idx, hyper_names, chunk, device)
            pending.append((fn(X, y, TW, EW, {**hyper_arg, **extras}), batch_idx))

    for out, batch_idx in pending:
        host = {k: v.cpu().numpy() for k, v in out.items()}
        for j, gi in enumerate(batch_idx):
            results[gi] = _postprocess(host, j, plan, kernel.task, scoring)
    return TrialRunResult(
        trial_metrics=[r for r in results if r is not None],
        run_time_s=time.perf_counter() - t0 - stream_wait,
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

    from ..data import stage_cache

    token = stage_cache.STAGE_CACHE.pin_begin() if stage_cache.enabled() else None
    try:
        return _fit_single_impl(kernel, data, plan, static, hyper, split, device)
    finally:
        if token is not None:
            stage_cache.STAGE_CACHE.pin_end(token)


def _fit_single_impl(kernel, data, plan, static, hyper, split, device):
    n, d = data.X.shape
    prepared = _prepared_data(kernel, data, static) if hasattr(kernel, "prepare_data") else None
    staging = _Staging(data, device)
    X = staging.X(kernel, static, prepared)
    y, TW, _ = staging.folds(plan)
    w = TW[split:split + 1]  # [1, n]
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


def run_trials_callable(kernel: ModelKernel, data: TrialData, plan: SplitPlan,
                        params_list: Sequence[Dict[str, Any]], scorer, *,
                        device: torch.device) -> List[Dict[str, Any]]:
    """Host-side path of a callable ``scoring``: per (trial, split),
    ``fit_single`` on ``device``, the fitted params exported to a fitted
    scikit-learn estimator (runtime/sklearn_export.py), and the user's
    ``scorer(estimator, X_eval, y_eval)`` on the host. Needs scikit-learn.
    A scorer that raises scores its split NaN; any non-finite split marks
    the trial diverged at -inf with the ``scorer_error``, and the job goes
    on. Returns per-trial metrics dicts shaped like ``_postprocess``'s
    (JAX ``run_trials_callable``)."""
    from ..runtime.sklearn_export import to_sklearn

    X_np = np.asarray(data.X)
    y_np = np.asarray(data.y)
    results: List[Dict[str, Any]] = []
    for params in params_list:
        split_scores: List[float] = []
        scorer_errors: List[str] = []
        for s in range(plan.n_splits):
            fitted, static = fit_single(kernel, data, plan, params, split=s, device=device)
            est = to_sklearn({"model_type": kernel.name, "parameters": params,
                              "static": dict(static), "fitted_params": fitted})
            keep = np.asarray(plan.eval_w[s]) > 0
            try:
                split_scores.append(float(scorer(est, X_np[keep], y_np[keep])))
            except Exception as e:  # noqa: BLE001 — a scorer bug fails this trial
                split_scores.append(float("nan"))
                scorer_errors.append(f"split {s}: {e!r}")
        metrics: Dict[str, Any] = {"scoring": "callable", "score": split_scores[0]}
        if plan.n_folds >= 2 and len(split_scores) > 1:
            metrics["cv_scores"] = split_scores[1:]
            metrics["mean_cv_score"] = float(np.mean(split_scores[1:]))
        else:
            metrics["mean_cv_score"] = split_scores[0]
        if not all(np.isfinite(v) for v in split_scores):
            metrics["mean_cv_score"] = float("-inf")
            metrics["diverged"] = True
            if scorer_errors:
                metrics["scorer_error"] = "; ".join(scorer_errors)
        results.append(metrics)
    return results


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
    (``kernel.prepared_key``): no valve changes the prepared forms, so a
    ``CS230_STREAM`` flip reuses them."""
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
    (outputs, trial indices) pairs.

    With curves on and more than one chunk, the score-vs-chunk curve:
    an extra ``chunk_eval`` after every ``curve_stride``-th chunk but the
    last (every prefix of the accumulator is a valid model), emitted with
    the final eval as the ``curve_score`` / ``curve_stride`` /
    ``curve_steps`` leaves, as in the JAX package."""
    from ..obs.curves import curve_points, curves_enabled

    n, n_splits = y.shape[0], int(plan.n_splits)
    n_chunks = int(chunk_plan["n_chunks"])
    curve_stride = (max(1, -(-n_chunks // curve_points()))
                    if curves_enabled() and n_chunks > 1 else 0)
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
        EWl = EW.repeat(chunk, 1)
        state = kernel.chunk_init(X, y, TWl, hyper_l, static)
        mids = []
        for ci in range(n_chunks):
            state = kernel.chunk_step(X, y, TWl, hyper_l, static, ci, state, chunk_plan)
            if curve_stride and (ci + 1) % curve_stride == 0 and ci < n_chunks - 1:
                mids.append(kernel.chunk_eval(X, y, EWl, hyper_l, static, state)["score"])
        res = kernel.chunk_eval(X, y, EWl, hyper_l, static, state)
        res = {k: v.reshape(chunk, n_splits, *v.shape[1:]) for k, v in res.items()}
        if curve_stride:
            res["curve_score"] = torch.stack(
                [m.reshape(chunk, n_splits) for m in mids] + [res["score"]], dim=-1)
            res["curve_stride"] = torch.full((chunk, n_splits), float(curve_stride),
                                             device=res["score"].device)
            res["curve_steps"] = torch.full((chunk, n_splits), float(n_chunks),
                                            device=res["score"].device)
        out.append((res, batch_idx))
    return out


def _run_streamed(kernel, static, X_host, hypers, idxs, hyper_names, plan: SplitPlan,
                  staging: _Staging, max_trials_per_batch: int):
    """One bucket through the kernel's out-of-core streaming driver (JAX
    ``trial_map.py:1929``). The full design matrix never stages:
    ``kernel.stream_form`` names the blockable host array,
    data/streaming.py tiles it into row blocks staged through the stage
    cache, and ``kernel.stream_scores`` accumulates
    across them. The fold tensors are padded to the blocks' ``n_pad``
    (zero weights) and staged as ordinary entries. Block keys carry the
    fingerprint, ``host_signature()``, the kernel's name and
    ``trace_salt()``, the form's salt and the block height. Returns the
    pending (outputs, trial indices) pairs and the seconds the consumer
    waited for blocks."""
    from ..data import stage_cache
    from ..data.streaming import RowBlockStreamer, array_block_source, plan_blocks

    data, device = staging.data, staging.device
    blockable, form_salt = kernel.stream_form(X_host, static)
    n = int(blockable.shape[0])
    bplan = plan_blocks(n, int(blockable.nbytes // max(n, 1)))
    base_key = (stage_cache.dataset_fingerprint(data), stage_cache.host_signature(device),
                "block", kernel.name, kernel.trace_salt(), tuple(form_salt), bplan.rows)
    streamer = RowBlockStreamer(base_key, array_block_source(blockable, bplan), bplan,
                                device=device, row_shape=tuple(blockable.shape[1:]))
    n_pad = bplan.n_pad

    def pad(a, dtype=None):
        a = np.asarray(a, dtype)
        return torch.as_tensor(np.concatenate(
            [a, np.zeros(a.shape[:-1] + (n_pad - n,), a.dtype)], axis=-1), device=device)

    y_d = staging.get_signed(plan.signature, ("stream_folds", n_pad, "y"), lambda: pad(data.y))
    TW_d = staging.get_signed(plan.signature, ("stream_folds", n_pad, "tw"),
                              lambda: pad(plan.train_w, np.float32))
    EW_d = staging.get_signed(plan.signature, ("stream_folds", n_pad, "ew"),
                              lambda: pad(plan.eval_w, np.float32))

    out = []
    chunk = min(max_trials_per_batch, len(idxs))
    for start in range(0, len(idxs), chunk):
        batch_idx = idxs[start : start + chunk]
        if hyper_names:
            last = [hypers[batch_idx[-1]]] * (chunk - len(batch_idx))
            hyper_batch = {k: np.asarray([hypers[gi][k] for gi in batch_idx]
                                         + [h[k] for h in last], np.float32)
                           for k in hyper_names}
        else:
            hyper_batch = {"_pad": np.zeros((chunk,), np.float32)}
        score = kernel.stream_scores(streamer, y_d, TW_d, EW_d, hyper_batch, static, n)
        out.append(({"score": torch.as_tensor(np.asarray(score))}, batch_idx))
    return out, streamer.stats["wait_s"]


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
