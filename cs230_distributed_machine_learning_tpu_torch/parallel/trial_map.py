"""Trial execution engine: batched fits of whole trial buckets, on one
device or sharded over the ranks of a trial mesh.

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

Trial sharding (``mesh=``, parallel/mesh.py; JAX ``trial_map.py:900``,
``:1312-1320``): over a mesh of N ranks every rank runs the same buckets
in the same order. Each chunk is padded to a multiple of N (of N x 128 on
the packed path, so every rank's shard is whole 128-trial blocks and B2
packs the same blocks it packs on one card); rank r dispatches its
contiguous shard on its own device; the winner of each chunk comes from
``collectives.best_trial`` over the shards (``device_best``, JAX
``_chunk_best``), and ``distributed.fetch`` assembles every output leaf
on every rank. The chunked protocol (``_run_chunked``) shards its trial
chunks the same way. Streamed buckets run only without a mesh. A mesh
of one rank is no mesh.

On a 2-D (trials, data) mesh (``trial_mesh(data_parallel=k)``; JAX
``:1600-1625``) a bucket of a ``row_shardable`` kernel (LogisticRegression)
without a chunked plan is row-sharded: each rank stages only its rows of
``X``, ``y`` and the fold weights (``mesh.row_range``, keyed with
``("rows", k, data_rank)``), its lanes are sharded over its trial group
(the chunk padded to 128 x the trial axis on the packed path), and the
kernel reduces its row sums over the data group (``static["_row_shard"]``,
models/logistic.py); the winner and the outputs are reduced and gathered
over the trial group. Every other bucket runs on the flat trial axis of
all ranks with the whole table, as the JAX package's chunked protocol
runs replicated (``replicate_only``).

``warm_only=True`` (the prewarm path, runtime/prewarm.py) loads the kernel
libraries and stages every bucket's tensors, then stops before any
dispatch: the result carries the compile and staging seconds and no
metrics.

Batch accounting (JAX ``TrialRunResult``): the run's phase timers tile its
wall, ``compile_time_s`` (the kernel libraries' first-use build or load,
ops/cuda_build.py), ``stage_time_s`` (staging uploads and the streamed
buckets' block waits), ``run_time_s`` (first dispatch to the last result on
the host, less the compile and staging inside that window) and, within it,
``fetch_time_s`` (the blocking device-to-host reads, which on the card also
wait for the kernels still queued). ``model_flops`` sums each bucket's
``2 * macs_estimate * splits * trials`` (``flops_coverage``: the share of
buckets priced); ``hbm_peak_bytes`` is the card's allocator high-water. The
compiler cost figures (``xla_flops``, ``bytes_accessed``) stay None: eager
PyTorch has no cost analysis. ``CS230_OBS=0`` leaves the cost fields None.

Compressed staging (``CS230_STAGE_DTYPE`` = f32 | bf16 | int8 | auto, with
``CS230_STAGE_LINK_MBPS`` and ``CS230_STAGE_AUTO_MBPS``; JAX ``:241-346``):
a one-device, unchunked bucket of a kernel without ``prepare_data``, on
the card's side of the host route, stages its raw matrix compressed on
the host (``stage_compress``, data/stage_codec.py) under ``("X", mode)``;
the dispatch widens it once a bucket (``stage_decode``), the packed
path's staged extras are made from the decoded matrix and keyed by the
mode, and a streamed bucket compresses each block. Every other bucket
stages f32.

The host route (``CS230_HOST_EXEC_MACS``; JAX ``:631-637``, ``:950-966``):
on a card, a bucket with no mesh and no chunk plan whose ``macs_estimate
* splits * trials`` is at most the cap runs on the host (``host_exec``),
staged there, with the kernels' plain versions; decided before streaming
and before any staging. The default is 0, off: the JAX package's 2e8 is
its TPU's dispatch trade-off, and on the H100 the one bucket measured
under it ran faster on the card (ROADMAP C39). Set the cap to route.

Two JAX transfer valves are accepted and change nothing here (ROADMAP
C37): ``CS230_PACKED_FETCH`` (XLA's one-buffer result fetch; the port
reads one tensor a leaf) and ``CS230_COST_ANALYSIS`` (XLA's compiler cost
capture, which eager PyTorch does not have; C19).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.stage_codec import stage_compress, stage_decode, to_device
from ..models.base import ModelKernel, TrialData
from ..obs import obs_enabled, observe
from ..ops.folds import SplitPlan
from ..ops.metrics import validate_scoring
from .mesh import RowShard, effective_mesh, pad_to_multiple


@dataclasses.dataclass
class TrialRunResult:
    """Per-trial metrics in submission order, plus batch-level timing and
    the device cost accounting (the JAX fields; see the module docstring)."""

    trial_metrics: List[Dict[str, Any]]
    #: wall seconds from the first dispatch to the last result on the host,
    #: less the compile and staging seconds inside that window
    run_time_s: float
    #: kernel-library build / load seconds at first use (0 when warm)
    compile_time_s: float = 0.0
    #: dispatches queued (one a packed chunk, trial chunk or streamed chunk)
    n_dispatches: int = 0
    #: blocking device->host reads (one an output leaf) and their bytes
    n_host_fetches: int = 0
    result_bytes: int = 0
    #: staging uploads (cache misses and waits) plus streamed block waits
    stage_time_s: float = 0.0
    #: blocking device->host result reads
    fetch_time_s: float = 0.0
    #: 2 * macs * splits * trials summed over the priced buckets
    model_flops: Optional[float] = None
    #: compiler cost analysis: always None on eager PyTorch
    xla_flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    #: share of this run's buckets with a model-FLOP estimate
    flops_coverage: Optional[float] = None
    #: the card's allocator high-water at run end (monotonic over the
    #: process unless reset; the executor's sampler supplies the per-batch
    #: figure); None on the CPU
    hbm_peak_bytes: Optional[int] = None
    #: (submission-order index, mean_cv_score) of the winner as the mesh
    #: collective found it; None without a mesh
    device_best: Optional[tuple] = None


def _hbm_peak_bytes() -> Optional[int]:
    from ..utils.flops import device_memory_stats

    peak = device_memory_stats().get("peak_bytes_in_use")
    return int(peak) if peak is not None else None


def _call_with_prepared(fn, prepared, *args):
    """A kernel cost hook, given the prepared-data dict where its
    estimator prices it (the tree kernels)."""
    try:
        return fn(*args, prepared=prepared)
    except TypeError:
        return fn(*args)


def _device_sig(device: torch.device) -> tuple:
    """The device's identity in stage-cache keys: (type, index)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device() if device.type == "cuda" else 0
    return (device.type, int(index))


# ---- compressed staging uploads (JAX trial_map.py:241-346) ----------------


def _staging_dtype() -> str:
    mode = os.environ.get("CS230_STAGE_DTYPE", "f32").lower()
    return mode if mode in ("bf16", "int8", "auto") else "f32"


#: probed host->device upload rate (MB/s), measured once a process
_LINK_MBPS: Optional[float] = None


def _measured_link_mbps(device: torch.device) -> float:
    """Host->device upload rate in MB/s, the ``auto`` policy's input.
    ``CS230_STAGE_LINK_MBPS`` pins it; a CPU device is an infinitely fast
    link; otherwise two 4 MiB uploads to the card, the second timed (the
    first warms the transfer path), once a process."""
    global _LINK_MBPS
    env = os.environ.get("CS230_STAGE_LINK_MBPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device.type != "cuda":
        return float("inf")
    if _LINK_MBPS is None:
        probe = torch.zeros((4 << 20,), dtype=torch.uint8)
        probe.to(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        probe.to(device)
        torch.cuda.synchronize(device)
        _LINK_MBPS = probe.numel() / max(time.perf_counter() - t0, 1e-9) / 1e6
    return _LINK_MBPS


def _resolve_stage_mode(mode: str, device: torch.device) -> str:
    """The staging dtype, ``auto`` resolved: bf16 when the upload link is
    slower than ``CS230_STAGE_AUTO_MBPS`` (default 100 MB/s), f32
    otherwise. int8 stays opt-in (its quantization moves scores ~2e-2)."""
    if mode == "auto":
        threshold = float(os.environ.get("CS230_STAGE_AUTO_MBPS", 100.0))
        return "bf16" if _measured_link_mbps(device) < threshold else "f32"
    return mode


# ---- the host route for tiny buckets (JAX trial_map.py:631-637, 950-966) ---

#: buckets routed to the host since ``reset_host_route``, and their trials
HOST_ROUTE = {"buckets": 0, "trials": 0}


def reset_host_route() -> None:
    for k in HOST_ROUTE:
        HOST_ROUTE[k] = 0


def _host_exec_cap() -> float:
    """``CS230_HOST_EXEC_MACS``: a bucket of at most this many analytical
    MACs runs on the host; unset or 0, the route is off (ROADMAP C39)."""
    return float(os.environ.get("CS230_HOST_EXEC_MACS") or 0)


def bucket_macs(kernel, prepared, n: int, d: int, static, n_splits: int,
                n_trials: int) -> Optional[float]:
    """The bucket's analytical MACs, ``macs_estimate * splits * trials`` (the
    host route's measure; twice it is the bucket's model FLOPs), or None
    for a kernel that publishes no estimate."""
    if not hasattr(kernel, "macs_estimate"):
        return None
    macs = _call_with_prepared(kernel.macs_estimate, prepared, n, d, static)
    return float(macs) * max(int(n_splits), 1) * int(n_trials)


def host_exec(kernel, prepared, n: int, d: int, static, n_splits: int, n_trials: int, *,
              device: torch.device, mesh=None, chunk_plan=None) -> bool:
    """The JAX package's placement rule for tiny buckets: on a card, with no
    mesh and no chunk plan, a bucket whose analytical MACs are at most
    ``CS230_HOST_EXEC_MACS`` runs on the host, where one round trip to the
    card would cost more than its whole work. Off unless the cap is set
    (ROADMAP C39). A placement, not a fallback: it reads neither whether a
    kernel builds nor whether a card works."""
    cap = _host_exec_cap()
    if cap <= 0 or device.type != "cuda" or mesh is not None or chunk_plan:
        return False
    macs = bucket_macs(kernel, prepared, n, d, static, n_splits, n_trials)
    return macs is not None and macs <= cap


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
        #: this run's staging seconds on this device: uploads (and waits for
        #: another thread's upload of the same entry) and streamed block
        #: waits; ``seconds`` adds the host route's
        self.own_seconds = 0.0
        self._sc = stage_cache if stage_cache.enabled() else None
        self._local: Dict[Any, Any] = {}
        self._folds: Dict[tuple, tuple] = {}
        self._host: Optional["_Staging"] = None

    @property
    def seconds(self) -> float:
        return self.own_seconds + (self._host.own_seconds if self._host is not None else 0.0)

    def host(self) -> "_Staging":
        """The run's staging on the host (the host route's buckets)."""
        if self._host is None:
            self._host = _Staging(self.data, torch.device("cpu"))
        return self._host

    def get(self, key: tuple, make, cache: bool = True):
        """The entry under ``key``, made on a miss. A miss's upload (and a
        wait for another thread's) adds to the run's staging seconds; only
        real uploads feed ``tpuml_executor_stage_seconds``."""
        t0 = time.perf_counter()
        if self._sc is None or not cache:
            if key in self._local:
                return self._local[key]
            val = self._local[key] = make()
            outcome = "miss"
        else:
            gkey = ((self._sc.dataset_fingerprint(self.data), _device_sig(self.device))
                    + tuple(key))
            val, outcome = self._sc.STAGE_CACHE.get_or_stage(gkey, make)
        if outcome != "hit":
            dt = time.perf_counter() - t0
            if outcome == "miss":
                observe("tpuml_executor_stage_seconds", dt)
            self.own_seconds += dt
        return val

    def get_signed(self, signature, key: tuple, make):
        """A fold-plan-derived entry, keyed ``key[0], signature, *key[1:]``:
        cached when the plan has a signature to key on, else made for this
        call alone."""
        return self.get(key[:1] + (signature,) + key[1:], make, cache=signature is not None)

    def folds(self, plan: SplitPlan, rows: Optional[RowShard] = None):
        """(y [n], TW [S, n], EW [S, n]) on the device; with ``rows`` only
        the rank's rows ``[rows.lo, rows.hi)``."""
        key = rows.key if rows is not None else ()
        if key not in self._folds:
            dev = self.device
            sl = slice(rows.lo, rows.hi) if rows is not None else slice(None)
            self._folds[key] = self.get_signed(plan.signature, ("folds",) + key, lambda: (
                torch.as_tensor(np.asarray(self.data.y)[sl], device=dev),
                torch.as_tensor(np.ascontiguousarray(plan.train_w[:, sl]), device=dev),
                torch.as_tensor(np.ascontiguousarray(plan.eval_w[:, sl]), device=dev)))
        return self._folds[key]

    def X(self, kernel, static, prepared):
        """The bucket's X: its prepared forms (a dict) or the raw f32 matrix."""
        dev = self.device
        if prepared is not None:
            return self.get(("prepared", kernel.name, kernel.prepared_key(static)),
                            lambda: {k: torch.as_tensor(v, device=dev)
                                     for k, v in prepared.items()})
        return self.get(("X",), lambda: torch.as_tensor(
            np.asarray(self.data.X, np.float32), device=dev))

    def X_compressed(self, mode: str):
        """The raw matrix's compressed staged form under ``mode`` (bf16 or
        int8: ``stage_compress``), keyed ``("X", mode)`` so that it never
        aliases the f32 entry; ``stage_decode`` widens it."""
        return self.get(("X", mode), lambda: to_device(
            stage_compress(self.data.X, mode), self.device))

    def X_rows(self, rows: RowShard):
        """The rank's rows ``[rows.lo, rows.hi)`` of the raw f32 matrix (a
        row-sharded bucket's X)."""
        return self.get(("X",) + rows.key, lambda: torch.as_tensor(
            np.asarray(self.data.X[rows.lo:rows.hi], np.float32), device=self.device))


def _device_memory_mb(device: torch.device) -> float:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 1e6
    return 8_000.0


def _memory_chunk_cap(kernel, n, d, static, n_splits, device, n_dev: int = 1,
                      share: int = 1) -> int:
    """Trials per generic dispatch bounded by device memory: each trial
    holds ~memory_estimate_mb per split at once, on each of ``n_dev``
    ranks' devices, each rank with its ``share``-th of its device. ``n``
    is the rows a rank holds (its row shard on a data axis)."""
    per_trial_mb = max(kernel.memory_estimate_mb(n, d, static), 0.5) * max(n_splits, 1)
    return max(n_dev, int(0.5 * _device_memory_mb(device) / share * n_dev / per_trial_mb))


def _packed_block_cap(kernel, static, n, d, n_classes, n_splits, device, share: int,
                      blocks: int) -> int:
    """The most trial blocks (at most ``blocks``, at least one) of a packed
    dispatch whose device bytes (``kernel.batched_memory_bytes``, a rank's
    share of the chunk) fit half of a rank's ``share``-th of its device, as
    ``_memory_chunk_cap`` bounds the generic path. Lanes are independent, so
    no score depends on it."""
    budget = 0.5 * _device_memory_mb(device) * 1e6 / share
    while blocks > 1 and kernel.batched_memory_bytes(static, n, d, n_classes, n_splits,
                                                     blocks) > budget:
        blocks -= 1
    return blocks


def run_trials(
    kernel: ModelKernel,
    data: TrialData,
    plan: SplitPlan,
    param_dicts: Sequence[Dict[str, Any]],
    *,
    device: torch.device,
    max_trials_per_batch: int = 256,
    scoring: Optional[str] = None,
    mesh=None,
    warm_only: bool = False,
) -> TrialRunResult:
    """Run all trials (one per param dict) on ``device``, bucketing by
    static config. ``scoring`` None keeps the task's default metric; a
    scorer name rides each bucket's static as ``_scoring`` and keeps the
    bucket off the packed, fused and streamed paths, which score by the
    default metric only (as in the reference). ``mesh`` (a TrialMesh of
    more than one rank; 1-D or 2-D) shards every chunk over the ranks,
    which must all make this call with the same arguments; the rank's
    device replaces ``device``. ``warm_only`` stages and loads, and dispatches nothing.
    The stage-cache entries the run touches are pinned while it runs."""
    from ..data import stage_cache

    token = stage_cache.STAGE_CACHE.pin_begin() if stage_cache.enabled() else None
    try:
        return _run_trials_impl(kernel, data, plan, param_dicts, device=device,
                                max_trials_per_batch=max_trials_per_batch, scoring=scoring,
                                mesh=mesh, warm_only=warm_only)
    finally:
        if token is not None:
            stage_cache.STAGE_CACHE.pin_end(token)


def _run_trials_impl(kernel, data, plan, param_dicts, *, device, max_trials_per_batch,
                     scoring, mesh=None, warm_only=False) -> TrialRunResult:
    from ..ops.cuda_build import load_seconds, warm_libraries
    from .distributed import LockstepLostError, PeerRankFailed, agree, fetch

    mesh = effective_mesh(mesh)
    share = int(mesh.device_share) if mesh is not None else 1
    if mesh is not None:
        device = mesh.device
    # this rank's part of the run (staging, dispatch) makes no collective;
    # over a mesh the ranks agree on it before the first result collective,
    # so a part that failed on one rank fails the run on every rank. A
    # row-sharded bucket's dispatch does reduce over its data group: those
    # dispatches are deferred to the end of the rank's part and the ranks
    # agree once before them too, so a rank that failed before them leaves
    # no peer waiting in a data collective
    agreeing = mesh is not None and not warm_only
    deferred: List[Any] = []
    agreed = False
    try:
        validate_scoring(scoring, kernel.task, data.n_classes, kernel)
        n, d = data.X.shape
        results: List[Optional[Dict[str, Any]]] = [None] * len(param_dicts)
        # cost accounting for THIS run (the valve read once: a mid-run flip
        # must not produce a half-priced result)
        acct = obs_enabled()
        model_flops = 0.0
        n_buckets = buckets_priced = 0
        compile0 = load_seconds()
        if warm_only and device.type == "cuda":
            warm_libraries()
        staging = _Staging(data, device)
        # the dispatch window opens at the first dispatch; the compile and
        # staging seconds inside it are the other phases', not the run's
        window: Dict[str, float] = {}

        def _dispatching() -> None:
            if not window:
                window.update(t=time.perf_counter(), compile=load_seconds(), stage=staging.seconds)

        buckets: Dict[Any, List[int]] = {}
        hypers: List[Dict[str, float]] = []
        for i, params in enumerate(param_dicts):
            static_key, hyper = kernel.canonicalize(params)
            hypers.append(hyper)
            buckets.setdefault(static_key, []).append(i)

        pending: List[Any] = []
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
            # the bucket's analytical model FLOPs, 2 * per-(trial, split) MACs
            # * splits * trials, whatever dispatch path it takes below
            n_buckets += 1
            if acct and hasattr(kernel, "macs_estimate"):
                try:
                    model_flops += 2.0 * bucket_macs(kernel, prepared, n, d, static,
                                                     plan.n_splits, len(idxs))
                    buckets_priced += 1
                except Exception:  # noqa: BLE001 — an estimator bug leaves the bucket unpriced
                    pass
            chunk_plan = None
            if hasattr(kernel, "chunked_plan"):
                chunk_plan = kernel.chunked_plan(static, n, d, data.n_classes, plan.n_splits,
                                                 prepared=prepared, device=device)
            # the mesh this bucket's lanes shard over: on a 2-D mesh a
            # row-sharded bucket's trial group, every other bucket the flat
            # trial axis of all ranks (whole table)
            shard = None
            bmesh = mesh
            if mesh is not None and mesh.data_size > 1:
                if getattr(kernel, "row_shardable", False) and not chunk_plan:
                    shard = mesh.row_shard(n)
                    static["_row_shard"] = shard
                    bmesh = mesh.trial_view()
                else:
                    bmesh = mesh.flat()
            n_dev = int(bmesh.world_size) if bmesh is not None else 1
            n_rows = shard.hi - shard.lo if shard is not None else n

            # the host route, decided before streaming and before any staging:
            # a tiny bucket runs on the host, with the kernels' plain versions
            on_host = host_exec(kernel, prepared, n, d, static, plan.n_splits, len(idxs),
                                device=device, mesh=mesh, chunk_plan=chunk_plan)
            bdev, bstaging = (torch.device("cpu"), staging.host()) if on_host else (device, staging)
            if on_host and not warm_only:
                HOST_ROUTE["buckets"] += 1
                HOST_ROUTE["trials"] += len(idxs)
            # compressed staging (CS230_STAGE_DTYPE): only the raw matrix of a
            # one-device, unchunked bucket on the card; every other bucket
            # stages f32
            stage_mode = (_resolve_stage_mode(_staging_dtype(), device)
                          if mesh is None and prepared is None and not chunk_plan and not on_host
                          else "f32")

            # out-of-core streaming, decided before any X staging so that the
            # oversized single-shot upload never happens
            if (not chunk_plan and scoring is None and mesh is None and not on_host
                    and hasattr(kernel, "stream_scores")):
                from ..data.stage_cache import _tree_nbytes
                from ..data.streaming import should_stream, stream_mode

                X_host = prepared if prepared is not None else np.asarray(data.X, np.float32)
                if (stream_mode() != "off" and kernel.stream_applicable(static, n, d)
                        and should_stream(_tree_nbytes(X_host))):
                    if warm_only:
                        continue  # nothing worth warming short of a whole block pass
                    _dispatching()
                    out, waited = _run_streamed(kernel, static, X_host, hypers, idxs, hyper_names,
                                                plan, staging, max_trials_per_batch, stage_mode)
                    pending.extend((o, bi, None) for o, bi in out)
                    # the blocking share of the transfer wall is staging time
                    staging.own_seconds += waited
                    continue

            if shard is not None:
                if prepared is not None:
                    raise ValueError(f"{kernel.name}: prepared forms are never row-sharded")
                X = staging.X_rows(shard)
            elif stage_mode != "f32":
                X = staging.X_compressed(stage_mode)
            else:
                X = bstaging.X(kernel, static, prepared)
            y, TW, EW = bstaging.folds(plan, rows=shard)
            if chunk_plan:
                if warm_only:
                    continue
                _dispatching()
                pending.extend((out, bi, bmesh) for out, bi in _run_chunked(
                    kernel, static, X, y, TW, EW, hypers, idxs, hyper_names, plan, chunk_plan,
                    d, device, bmesh))
                continue

            # kernels with a packed path (the LogReg kernel fit) take over the
            # whole chunk, with their own (larger) chunk geometry
            fn = None
            extras: Dict[str, Any] = {}
            if hasattr(kernel, "build_batched_fn") and scoring is None and not on_host:
                # every rank's shard is whole trial blocks; the cap is the
                # kernel's per device. ``n`` is the rows the rank holds
                Tw = kernel.batched_trial_multiple * n_dev
                chunk = max(Tw, min(kernel.batched_chunk_cap * n_dev,
                                    pad_to_multiple(len(idxs), Tw)))
                if hasattr(kernel, "batched_memory_bytes"):
                    chunk = Tw * _packed_block_cap(kernel, static, n_rows, d, data.n_classes,
                                                   plan.n_splits, device, share, chunk // Tw)
                fn = kernel.build_batched_fn(
                    static=static, n=n_rows, d=d, n_classes=data.n_classes,
                    n_splits=plan.n_splits, chunk=chunk // n_dev, device=device,
                )
            made: Dict[str, Any] = {}  # made once a bucket, at its dispatch
            if fn is not None and hasattr(kernel, "batched_staged_extras"):
                # dispatch-invariant forms staged once per (dataset, device,
                # staging mode, subkey) and merged into every dispatch's hypers;
                # a row shard's forms carry its rows in the key. The makers
                # get the staged X and its decode
                specs = kernel.batched_staged_extras(
                    static=static, n=n_rows, d=d, n_classes=data.n_classes,
                    n_splits=plan.n_splits, fold_signature=plan.signature, device=device)
                ctx = {"X": X, "y": y, "TW": TW, "EW": EW, "decode": stage_decode}
                rows_key = shard.key if shard is not None else ()
                for name in sorted(specs):
                    subkey, make = specs[name]
                    if subkey is None:  # nothing stable to key on: made once a bucket
                        made[name] = lambda m=make, c=ctx: m(c)
                    else:
                        extras[name] = staging.get(
                            ("batched_extra", kernel.name, name, stage_mode) + tuple(subkey)
                            + rows_key,
                            lambda m=make: m(ctx))
            if fn is None:
                if on_host:  # no device memory to bound
                    chunk = min(max_trials_per_batch, len(idxs))
                else:
                    mem_cap = _memory_chunk_cap(kernel, n_rows, d, static, plan.n_splits,
                                                device, n_dev, share)
                    chunk = min(max_trials_per_batch, mem_cap, pad_to_multiple(len(idxs), n_dev))
                    chunk = max(n_dev, pad_to_multiple(chunk, n_dev))

                def fn(X, y, TW, EW, hyper, static=static):
                    return kernel.batched_scores(X, y, TW, EW, hyper, static)

            if warm_only:
                continue  # staged and built: the prewarm stops before dispatching

            def dispatch(fn=fn, X=X, y=y, TW=TW, EW=EW, extras=extras, made=made, idxs=idxs,
                         hyper_names=hyper_names, chunk=chunk, bmesh=bmesh, bdev=bdev):
                extras = {**extras, **{k: make() for k, make in made.items()}}
                X = stage_decode(X)  # a compressed staging widens first, once a bucket
                lanes = bmesh.shard(chunk) if bmesh is not None else None
                for start in range(0, len(idxs), chunk):
                    batch_idx = idxs[start : start + chunk]
                    hyper_arg = _hyper_batch(hypers, batch_idx, hyper_names, chunk, bdev, lanes)
                    _dispatching()
                    pending.append((fn(X, y, TW, EW, {**hyper_arg, **extras}), batch_idx, bmesh))

            if shard is not None:
                deferred.append(dispatch)
            else:
                dispatch()
        if deferred and agreeing:
            agreed = True
            agree(True, mesh)
        for dispatch in deferred:
            dispatch()
    except Exception as e:
        if agreeing and not agreed:
            agree(False, mesh)
        if agreed and not isinstance(e, PeerRankFailed):
            raise LockstepLostError(f"rank {mesh.rank} failed in a row-sharded dispatch, "
                                    f"whose data peers wait in its collectives: {e}") from e
        raise
    if agreeing:
        agree(True, mesh)

    # one blocking read an output leaf; on the card each waits for the
    # kernels still queued before it. Over a mesh each chunk's winner is
    # reduced first, then every leaf is all-gathered, over the bucket's
    # lane mesh: the same collectives in the same order on every rank. A
    # rank that fails between them leaves its siblings in one it never
    # enters (LockstepLostError)
    fetch_s = 0.0
    n_fetches = result_bytes = 0
    device_best: Optional[tuple] = None
    hosts = []
    try:
        for out, batch_idx, bmesh in pending:
            t_fetch = time.perf_counter()
            if bmesh is not None:
                bi, bs = _chunk_best(out["score"], len(batch_idx), plan, bmesh)
                n_fetches += 2
                if bi < len(batch_idx) and np.isfinite(bs):
                    gi = batch_idx[bi]
                    # sklearn's first-max rule over the whole run: on equal
                    # scores the smaller submission index
                    if (device_best is None or bs > device_best[1]
                            or (bs == device_best[1] and gi < device_best[0])):
                        device_best = (gi, bs)
            host = fetch(out, bmesh)
            dt = time.perf_counter() - t_fetch
            observe("tpuml_executor_fetch_seconds", dt)
            fetch_s += dt
            hosts.append((host, batch_idx))
    except Exception as e:
        if mesh is None:
            raise
        raise LockstepLostError(f"rank {mesh.rank} failed between a run's collectives: "
                                f"{e}") from e
    for host, batch_idx in hosts:
        n_fetches += len(host)
        result_bytes += sum(int(a.nbytes) for a in host.values())
        for j, gi in enumerate(batch_idx):
            results[gi] = _postprocess(host, j, plan, kernel.task, scoring)
    compile_s = load_seconds() - compile0
    run_s = 0.0
    if window:
        run_s = max(time.perf_counter() - window["t"] - (load_seconds() - window["compile"])
                    - (staging.seconds - window["stage"]), 0.0)
    if compile_s > 0.0:
        observe("tpuml_executor_compile_seconds", compile_s)
    return TrialRunResult(
        trial_metrics=[r for r in results if r is not None],
        run_time_s=run_s,
        compile_time_s=compile_s,
        n_dispatches=len(pending),
        n_host_fetches=n_fetches,
        result_bytes=result_bytes,
        stage_time_s=staging.seconds,
        fetch_time_s=fetch_s,
        model_flops=model_flops if acct and buckets_priced else None,
        flops_coverage=buckets_priced / n_buckets if acct and n_buckets else None,
        hbm_peak_bytes=_hbm_peak_bytes() if acct else None,
        device_best=device_best,
    )


def _chunk_best(score: torch.Tensor, n_valid: int, plan: SplitPlan, mesh) -> tuple:
    """This rank's shard of a chunk's ``[lanes, S]`` scores -> the chunk's
    (lane, mean-CV score) winner over every rank (JAX ``_chunk_best``):
    the mean of the CV folds (the holdout alone without folds), padding
    lanes and non-finite means ranked last, first max on ties."""
    from .collectives import best_trial

    local = int(score.shape[0])
    lo = mesh.rank * local
    mean_cv = score[:, 1:].mean(dim=1) if plan.n_folds >= 2 else score[:, 0]
    valid = torch.arange(lo, lo + local, device=score.device) < int(n_valid)
    return best_trial(mean_cv, mesh, valid_mask=valid, offset=lo)


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


def _hyper_batch(hypers, batch_idx, hyper_names, chunk, device,
                 lanes: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """``[chunk]`` tensors of the chunk's hypers, padded with the last
    trial's values (padded lanes are computed and dropped). A kernel with
    no traced hypers gets a ``_pad`` of zeros, which carries the chunk's
    trial count. ``lanes`` ``(start, stop)`` keeps a rank's shard."""
    lo, hi = lanes if lanes is not None else (0, chunk)
    if not hyper_names:
        return {"_pad": torch.zeros((hi - lo,), dtype=torch.float32, device=device)}
    hyper_batch = {
        k: np.full((chunk,), hypers[batch_idx[-1]][k], np.float32) for k in hyper_names
    }
    for j, gi in enumerate(batch_idx):
        for k in hyper_names:
            hyper_batch[k][j] = hypers[gi][k]
    return {k: torch.as_tensor(v[lo:hi], device=device) for k, v in hyper_batch.items()}


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
                 chunk_plan, d, device, mesh=None) -> List[Any]:
    """One bucket through the kernel's chunked-fit protocol: per trial
    chunk, ``chunk_init`` -> n_chunks x ``chunk_step`` -> ``chunk_eval``
    over all (trial, split) lanes; the state between steps (a forest's
    summed leaf predictions, a KNN's predicted query rows) never leaves the
    device. ``d`` is the table's feature count. The trial chunk is bounded
    by the state's memory, the kernel's working set and 64 trials a device
    (``trial_map.py:1707`` there), and over a mesh padded to a multiple of
    its ranks, each rank running every chunk step for its own shard of the
    lanes (JAX ``:1649``, ``:1870-1874``). Returns the pending (outputs,
    trial indices) pairs; the outputs are the rank's shard.

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
    n_dev = int(mesh.world_size) if mesh is not None else 1
    share = int(mesh.device_share) if mesh is not None else 1
    state_mb = 4.0 * n * max(n_classes, 1) * n_splits / 1e6
    mem_cap = _memory_chunk_cap(kernel, n, d, static, n_splits, device, n_dev, share)
    chunk = max(1, min(len(idxs), mem_cap,
                       int(0.25 * n_dev * _device_memory_mb(device) / share
                           / max(state_mb, 1.0)),
                       64 * n_dev))
    chunk = max(n_dev, pad_to_multiple(chunk, n_dev))
    lanes = mesh.shard(chunk) if mesh is not None else (0, chunk)
    local = lanes[1] - lanes[0]
    out = []
    for start in range(0, len(idxs), chunk):
        batch_idx = idxs[start : start + chunk]
        hyper = _hyper_batch(hypers, batch_idx, hyper_names, chunk, device, lanes)
        # lane = trial * S + split: the fold masks repeated per trial
        TWl = TW.repeat(local, 1)
        hyper_l = {k: v.repeat_interleave(n_splits) for k, v in hyper.items()}
        EWl = EW.repeat(local, 1)
        state = kernel.chunk_init(X, y, TWl, hyper_l, static)
        mids = []
        for ci in range(n_chunks):
            state = kernel.chunk_step(X, y, TWl, hyper_l, static, ci, state, chunk_plan)
            if curve_stride and (ci + 1) % curve_stride == 0 and ci < n_chunks - 1:
                mids.append(kernel.chunk_eval(X, y, EWl, hyper_l, static, state)["score"])
        res = kernel.chunk_eval(X, y, EWl, hyper_l, static, state)
        res = {k: v.reshape(local, n_splits, *v.shape[1:]) for k, v in res.items()}
        if curve_stride:
            res["curve_score"] = torch.stack(
                [m.reshape(local, n_splits) for m in mids] + [res["score"]], dim=-1)
            res["curve_stride"] = torch.full((local, n_splits), float(curve_stride),
                                             device=res["score"].device)
            res["curve_steps"] = torch.full((local, n_splits), float(n_chunks),
                                            device=res["score"].device)
        out.append((res, batch_idx))
    return out


def _run_streamed(kernel, static, X_host, hypers, idxs, hyper_names, plan: SplitPlan,
                  staging: _Staging, max_trials_per_batch: int, stage_mode: str = "f32"):
    """One bucket through the kernel's out-of-core streaming driver (JAX
    ``trial_map.py:1929``). The full design matrix never stages:
    ``kernel.stream_form`` names the blockable host array,
    data/streaming.py tiles it into row blocks staged through the stage
    cache, and ``kernel.stream_scores`` accumulates
    across them. Under a compressed ``stage_mode`` each raw block is
    compressed on the host before its upload (``stage_compress``) and the
    driver decodes it (``stage_decode``, data/stage_codec.py). The fold
    tensors are padded to the blocks' ``n_pad`` (zero weights) and staged
    as ordinary entries. Block keys carry the fingerprint,
    ``host_signature()``, the kernel's name and ``trace_salt()``, the
    form's salt, the staging mode and the block height. Returns the
    pending (outputs, trial indices) pairs and the seconds the consumer
    waited for blocks."""
    from ..data import stage_cache
    from ..data.streaming import RowBlockStreamer, array_block_source, plan_blocks

    data, device = staging.data, staging.device
    blockable, form_salt = kernel.stream_form(X_host, static)
    n = int(blockable.shape[0])
    bplan = plan_blocks(n, int(blockable.nbytes // max(n, 1)))
    base_key = (stage_cache.dataset_fingerprint(data), stage_cache.host_signature(device),
                "block", kernel.name, kernel.trace_salt(), tuple(form_salt), stage_mode,
                bplan.rows)
    source = array_block_source(blockable, bplan)
    if stage_mode != "f32":
        raw = source

        def source(i):
            return stage_compress(raw(i), stage_mode)
    streamer = RowBlockStreamer(base_key, source, bplan,
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
