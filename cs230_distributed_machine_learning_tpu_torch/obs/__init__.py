"""Observability facade: unified metrics registry + end-to-end job tracing.

Port of the JAX package's ``obs/__init__.py`` (framework-free; the device
profiler in ``.devprof`` runs on ``torch.profiler``).

Every runtime layer instruments through this module, never through
``metrics``/``tracing`` directly, because the facade owns the one global
valve:

    CS230_OBS=0   -> every helper below is a near-free no-op (one env
                     read); ``span()`` yields a shared inert handle.

The subsystems:

- :mod:`.metrics` — thread-safe counters/gauges/histograms exposed in
  Prometheus text format at ``GET /metrics/prom``. The full family
  catalog is registered eagerly below so scrapes see every name from the
  first request (documented in docs/OBSERVABILITY.md).
- :mod:`.tracing` — Dapper-style spans with ``trace_id`` propagated over
  the REST control plane (``X-Trace-Id`` header, task-spec stamping,
  agent span shipping); ``GET /trace/<job_id>`` returns the span tree.
- :mod:`.recorder` — the flight recorder: bounded per-subtask lifecycle
  events (placement score breakdowns, lease grant/reclaim, retries,
  speculation, quarantine) behind ``GET /explain/<job>/<subtask>`` and
  ``GET /events``.
- :mod:`.timeseries` — an embedded in-memory time-series ring sampling
  the registry on the sweep/scrape cadence; ``GET /metrics/history``.

Usage (hot paths pay one env check when disabled):

    from ..obs import obs_enabled, counter_inc, observe, span

    counter_inc("tpuml_subtasks_completed_total")
    observe("tpuml_executor_fetch_seconds", dt)
    with span("executor.batch", trace_id=tid, worker=wid) as sp:
        sp.attrs["n_dispatches"] = run.n_dispatches
"""

from __future__ import annotations

from typing import Optional, Sequence

from .critpath import (  # noqa: F401 — re-exported API
    compare as compare_critical_paths,
    critical_path,
)
from .devprof import (  # noqa: F401 — re-exported API
    PROFILER,
    DeviceProfiler,
    device_seconds,
    record_batch_device_seconds,
)
from .export import (  # noqa: F401 — re-exported API
    export_trace,
    to_otlp,
    to_perfetto,
)
from .metrics import (  # noqa: F401 — re-exported API
    CALIBRATION_BUCKETS,
    DEFAULT_BUCKETS,
    HTTP_BUCKETS,
    PLACEMENT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from .recorder import (  # noqa: F401 — re-exported API
    RECORDER,
    FlightRecorder,
    record_event,
)
from .signals import CapacitySignals  # noqa: F401 — re-exported API
from .slo import (  # noqa: F401 — re-exported API
    AlertEngine,
    AlertRule,
    default_rules,
)
from .timeseries import (  # noqa: F401 — re-exported API
    TIMESERIES,
    TimeSeriesStore,
    timeseries_sample,
)
from .tracing import _enabled as _valve
from .tracing import flush_journal  # noqa: F401 — re-exported API
from .tracing import (  # noqa: F401 — re-exported API
    PARENT_HEADER,
    TRACE_HEADER,
    TRACER,
    Tracer,
    activate,
    active_tracer,
    current_span_id,
    current_trace_id,
    new_trace_id,
    process_token,
    record_phase,
    span,
    use_tracer,
)


def obs_enabled() -> bool:
    """The master valve (single definition: tracing._enabled). Read per
    call (one env lookup) so tests and operators can flip ``CS230_OBS``
    on a live process."""
    return _valve()


# ---------------- valve-gated metric helpers ----------------


def counter_inc(name: str, amount: float = 1.0, **labels: str) -> None:
    if not obs_enabled():
        return
    REGISTRY.counter(name).inc(amount, **labels)


def gauge_set(name: str, value: float, **labels: str) -> None:
    if not obs_enabled():
        return
    REGISTRY.gauge(name).set(value, **labels)


def observe(
    name: str,
    value: float,
    buckets: Optional[Sequence[float]] = None,
    **labels: str,
) -> None:
    if not obs_enabled():
        return
    if buckets is not None:
        REGISTRY.histogram(name, buckets=buckets).observe(value, **labels)
    else:
        REGISTRY.histogram(name).observe(value, **labels)


def render_prometheus() -> str:
    return REGISTRY.render()


def refresh_route_p99() -> None:
    """Derive ``tpuml_http_route_p99_seconds{route=}`` from the request
    histogram (methods and codes pooled per route). Called at scrape and
    sweep time — the gauge exists so the embedded time-series ring can
    sample a p99 without sampling histogram buckets (obs/timeseries.py
    deliberately skips histograms)."""
    if not obs_enabled():
        return
    h = REGISTRY.get("tpuml_http_request_seconds")
    if not isinstance(h, Histogram):
        return
    routes = sorted({ls.get("route") for ls in h.labelsets() if ls.get("route")})
    g = REGISTRY.gauge("tpuml_http_route_p99_seconds")
    for route in routes:
        p99 = h.quantile_where(0.99, route=route)
        if p99 is not None:
            g.set(p99, route=route)


# ---------------- metric catalog ----------------
#
# Registered eagerly so every family is present (at zero) in the first
# scrape. Names, types, and meanings are documented in
# docs/OBSERVABILITY.md — keep the two in sync.

_CATALOG_REGISTERED = False


def register_catalog() -> None:
    global _CATALOG_REGISTERED
    if _CATALOG_REGISTERED:
        return
    _CATALOG_REGISTERED = True
    c, g, h = REGISTRY.counter, REGISTRY.gauge, REGISTRY.histogram
    c("tpuml_jobs_submitted_total", "Train jobs accepted by the coordinator")
    c("tpuml_jobs_completed_total", "Jobs finalized successfully")
    c("tpuml_jobs_failed_total", "Jobs finalized as failed")
    c(
        "tpuml_subtasks_dispatched_total",
        "Subtasks placed onto a worker by the scheduler (requeues re-count)",
    )
    c("tpuml_subtasks_completed_total", "Subtask executions that completed")
    c("tpuml_subtasks_failed_total", "Subtask executions that failed")
    c(
        "tpuml_subtasks_requeued_total",
        "Subtasks requeued off a dead/unsubscribed/evicted worker",
    )
    # ---- fault-tolerance layer (docs/ROBUSTNESS.md) ----
    c(
        "tpuml_subtasks_retried_total",
        "Subtask re-dispatches by the fault-tolerance layer, labeled by "
        "reason (failure|lease)",
    )
    c(
        "tpuml_subtasks_quarantined_total",
        "Subtasks quarantined after exhausting their retry budget or "
        "killing too many worker backends",
    )
    c(
        "tpuml_speculative_launched_total",
        "Speculative (backup) duplicates launched for straggling subtasks",
    )
    c(
        "tpuml_speculative_won_total",
        "Speculative duplicates whose result was accepted first",
    )
    c(
        "tpuml_speculative_wasted_total",
        "Duplicate results dropped for subtasks that were speculated "
        "(the losing copy's work)",
    )
    # ---- coordinator crash recovery + overload survival
    # (docs/ROBUSTNESS.md "Coordinator recovery") ----
    g(
        "tpuml_coordinator_recovery_seconds",
        "Wall time of the last boot recovery: journal replay plus "
        "in-flight job re-queue",
    )
    c(
        "tpuml_recovery_replayed_ops_total",
        "Journal operations replayed at boot, labeled by op",
    )
    c(
        "tpuml_recovery_jobs_resumed_total",
        "Unfinished jobs re-queued by resume_inflight after a restart",
    )
    c(
        "tpuml_recovery_subtasks_requeued_total",
        "Subtasks re-dispatched by resume_inflight (no journaled result)",
    )
    c(
        "tpuml_results_duplicate_dropped_total",
        "Duplicate terminal results dropped at ingest (requeue races, "
        "speculative losers, zombie attempts from before a restart)",
    )
    c(
        "tpuml_jobs_rejected_total",
        "Submits rejected by admission control (429), labeled by reason "
        "(global_inflight|session_inflight|queue_depth)",
    )
    c(
        "tpuml_overload_shed_total",
        "Optional work shed under overload, labeled by kind "
        "(speculative|prewarm)",
    )
    c(
        "tpuml_agent_reconnects_total",
        "Agent re-registrations after a coordinator restart "
        "(404 on /next_tasks)",
    )
    c(
        "tpuml_agent_results_buffered_total",
        "Results parked in an agent's local buffer during a coordinator "
        "outage",
    )
    c(
        "tpuml_agent_results_dropped_total",
        "Buffered results dropped because the agent's bounded buffer "
        "overflowed (the subtask re-runs via recovery/lease machinery)",
    )
    c(
        "tpuml_agent_orphan_results_total",
        "Results ingested from worker ids this coordinator never "
        "registered (agents flushing buffers across a restart)",
    )
    c("tpuml_agent_polls_total", "GET /next_tasks long-polls served")
    c(
        "tpuml_agent_tasks_pulled_total",
        "Subtasks handed to remote agents over /next_tasks",
    )
    c(
        "tpuml_agent_acks_total",
        "Task results acknowledged over POST /task_result",
    )
    c(
        "tpuml_executable_cache_hits_total",
        "In-process compiled-executable cache hits (trial engine)",
    )
    c(
        "tpuml_executable_cache_misses_total",
        "In-process compiled-executable cache misses (trial engine)",
    )
    c("tpuml_aot_cache_hits_total", "AOT disk-cache blob deserializations")
    c(
        "tpuml_aot_cache_misses_total",
        "AOT disk-cache misses (fresh trace/export)",
    )
    # ---- staged-dataset cache (docs/OBSERVABILITY.md "Data-plane
    # caching") ----
    c(
        "tpuml_stage_cache_hits_total",
        "Staged-dataset cache hits (a device-resident tensor reused "
        "across jobs)",
    )
    c(
        "tpuml_stage_cache_misses_total",
        "Staged-dataset cache misses (a staging upload was required)",
    )
    c(
        "tpuml_stage_cache_uploads_total",
        "Actual host->device staging uploads performed — exactly one per "
        "(dataset, device, staging form) under concurrent same-dataset "
        "jobs (single-flight contract)",
    )
    c(
        "tpuml_stage_cache_evictions_total",
        "Staged entries LRU-evicted under the device-memory budget",
    )
    g(
        "tpuml_stage_cache_bytes",
        "Device bytes held by the staged-dataset cache",
    )
    g(
        "tpuml_stage_cache_entries",
        "Entries resident in the staged-dataset cache",
    )
    # ---- elastic trial fabric (docs/ARCHITECTURE.md "Elastic trial
    # fabric") ----
    c(
        "tpuml_stage_cache_replications_total",
        "Mesh-shaped cache entries built by on-device broadcast/reshard "
        "(ICI) from an already-resident host copy — never a tunnel upload",
    )
    c(
        "tpuml_stage_cache_tunnel_bytes_total",
        "Bytes staged over the slow host->device tunnel (cache misses of "
        "tunnel-transport entries)",
    )
    c(
        "tpuml_stage_cache_ici_bytes_total",
        "Bytes moved device-to-device building "
        "mesh-shaped staged entries",
    )
    c(
        "tpuml_stage_cache_overflow_total",
        "Stage-budget overflows: every LRU survivor was pinned so the "
        "cache is committed beyond its budget (reason=pinned), or "
        "CS230_STAGE_STRICT refused an oversize upload (reason=strict)",
    )
    # ---- out-of-core row-block streaming (docs/ARCHITECTURE.md
    # "Out-of-core streaming") ----
    c(
        "tpuml_stream_blocks_total",
        "Row blocks served to streaming passes (cache hits + uploads)",
    )
    c(
        "tpuml_stream_bytes_total",
        "Bytes uploaded staging row blocks (post-compression, misses only)",
    )
    c(
        "tpuml_stream_upload_seconds_total",
        "Transfer wall spent uploading row blocks on the prefetch worker",
    )
    c(
        "tpuml_stream_wait_seconds_total",
        "Wall the streaming consumer spent blocked waiting for a block "
        "(the NON-hidden share of the transfer wall)",
    )
    c(
        "tpuml_stream_passes_total",
        "Complete passes over a streamed dataset's block set",
    )
    c(
        "tpuml_mesh_reshards_total",
        "Fleet mesh-generation bumps, labeled by reason "
        "(join|death|evict|unsubscribe)",
    )
    g(
        "tpuml_mesh_generation",
        "Current fleet mesh generation (bumped on every worker "
        "join/death/eviction; journal-replayed across coordinator "
        "restarts)",
    )
    g(
        "tpuml_mesh_devices_total",
        "Devices across every live worker's mesh slice (the data-plane "
        "width placements pack onto)",
    )
    # ---- background AOT prewarm (docs/OBSERVABILITY.md "Data-plane
    # caching") ----
    c(
        "tpuml_prewarm_warmed_total",
        "Prewarm hints warmed (executables constructed + tensors staged "
        "in the background), labeled by model",
    )
    c(
        "tpuml_prewarm_skipped_total",
        "Prewarm hints skipped, labeled by reason (duplicate|error)",
    )
    c("tpuml_http_requests_total", "REST requests served, labeled by endpoint")
    c("tpuml_trace_spans_ingested_total", "Remote spans accepted via /trace_spans")
    g("tpuml_workers_alive", "Workers currently registered with the scheduler")
    h(
        "tpuml_scheduler_placement_seconds",
        "Placement-decision latency (place() wall time)",
        buckets=PLACEMENT_BUCKETS,
    )
    h(
        "tpuml_executor_compile_seconds",
        "Per-batch kernel-library build or load at first use (0 when warm)",
    )
    h(
        "tpuml_executor_stage_seconds",
        "Host->device staging uploads (dataset/fold tensors, cache misses only)",
    )
    h(
        "tpuml_executor_dispatch_seconds",
        "Per-batch device execution window (dispatch to last result ready)",
    )
    h(
        "tpuml_executor_fetch_seconds",
        "Blocking device->host result fetches",
    )
    # ---- device cost accounting (docs/OBSERVABILITY.md "Cost accounting") ----
    c(
        "tpuml_executor_flops_total",
        "Model FLOPs executed per batch (analytical estimate), labeled "
        "by model",
    )
    c(
        "tpuml_executor_bytes_total",
        "Bytes accessed per batch per compiler cost analysis, labeled by "
        "model (eager PyTorch has none: the family stays at zero)",
    )
    g(
        "tpuml_executor_mfu",
        "Model-FLOP utilization of the most recent batch (fraction of "
        "device peak), labeled by model; absent on CPU backends",
    )
    g(
        "tpuml_device_hbm_bytes",
        "Local device memory, labeled kind=used|peak|limit (absent when "
        "the backend exposes no memory_stats)",
    )
    # ---- per-worker health (docs/OBSERVABILITY.md "Worker health") ----
    g(
        "tpuml_worker_ewma_batch_seconds",
        "EWMA of a worker's batch wall time, labeled by wid",
    )
    g(
        "tpuml_worker_heartbeat_age_seconds",
        "Seconds since a worker's last heartbeat, labeled by wid "
        "(refreshed at scrape)",
    )
    g(
        "tpuml_worker_failure_ratio",
        "Failed / total subtask outcomes per worker, labeled by wid",
    )
    g(
        "tpuml_worker_queue_depth",
        "Queued subtasks per worker, labeled by wid",
    )
    g(
        "tpuml_worker_straggler",
        "1 while a worker is flagged as a straggler, labeled by wid",
    )
    g(
        "tpuml_worker_breaker_state",
        "Circuit-breaker state per worker, labeled by wid (0 closed, "
        "1 half-open; evicted workers' cells are removed)",
    )
    # ---- predictor calibration (docs/OBSERVABILITY.md "Predictor
    # calibration") ----
    h(
        "tpuml_predictor_abs_rel_error",
        "Runtime-predictor error per observed subtask: |predicted - "
        "actual| / actual (dimensionless), labeled by model family",
        buckets=CALIBRATION_BUCKETS,
    )
    g(
        "tpuml_predictor_calibration_ratio",
        "EWMA of predicted/actual runtime per model family, labeled by "
        "model (1.0 = calibrated; >1 overestimates — leases too loose; "
        "<1 underestimates — false lease reclaims)",
    )
    # ---- flight recorder (docs/OBSERVABILITY.md "Flight recorder") ----
    c(
        "tpuml_recorder_events_total",
        "Lifecycle events recorded by the flight recorder, labeled by "
        "kind (placement, lease.reclaim, attempt, retry, quarantine, ...)",
    )
    # ---- perf observatory (docs/OBSERVABILITY.md "Perf observatory") ----
    c(
        "tpuml_executor_device_seconds_total",
        "Accumulated device/pipeline seconds per batch phase, labeled by "
        "phase (stage|compile|dispatch|fetch) — executor-local batches "
        "plus remote agents' batches at metrics ingest",
    )
    c(
        "tpuml_profile_captures_total",
        "Completed on-demand torch.profiler captures "
        "(POST /profile/start|stop)",
    )
    h(
        "tpuml_http_request_seconds",
        "Control-plane request latency, labeled by route (endpoint name), "
        "method, and code",
        buckets=HTTP_BUCKETS,
    )
    g(
        "tpuml_http_route_p99_seconds",
        "Per-route p99 request latency, derived from "
        "tpuml_http_request_seconds at scrape/sweep time so the embedded "
        "time-series ring can sample it, labeled by route",
    )
    g(
        "tpuml_sse_lag_seconds",
        "Delivery lag of the most recent SSE progress event beyond the "
        "stream's tick cadence (seconds a subscriber saw its event late)",
    )
    # ---- fleet health plane (docs/OBSERVABILITY.md "Fleet health
    # plane") ----
    g(
        "tpuml_autoscale_desired_workers",
        "Capacity signal: workers this coordinator should run, derived "
        "from predictor-priced backlog + admission/latency pressure with "
        "scale-down hysteresis (obs/signals.py; GET /autoscale)",
    )
    g(
        "tpuml_autoscale_desired_shards",
        "Capacity signal: coordinator shards the fleet should run, sized "
        "to autoscale_target_fill of the carved admission caps "
        "(obs/signals.py; GET /autoscale)",
    )
    g(
        "tpuml_autoscale_backlog_seconds",
        "Predictor-priced backlog the capacity deriver last folded: "
        "queued load books plus unplaced pending subtasks at the mean "
        "queued estimate (seconds)",
    )
    g(
        "tpuml_alert_firing",
        "1 while an alert rule is firing, 0 once resolved, labeled by "
        "rule (obs/slo.py; GET /alerts)",
    )
    c(
        "tpuml_alerts_fired_total",
        "alert.fire transitions of the SLO rules engine, labeled by rule",
    )
    c(
        "tpuml_alerts_resolved_total",
        "alert.resolve transitions of the SLO rules engine, labeled by "
        "rule",
    )


register_catalog()

__all__ = [
    "obs_enabled",
    "counter_inc",
    "gauge_set",
    "observe",
    "render_prometheus",
    "refresh_route_p99",
    "register_catalog",
    "REGISTRY",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_BUCKETS",
    "PLACEMENT_BUCKETS",
    "HTTP_BUCKETS",
    "CALIBRATION_BUCKETS",
    "PROFILER",
    "DeviceProfiler",
    "device_seconds",
    "record_batch_device_seconds",
    "RECORDER",
    "FlightRecorder",
    "record_event",
    "TIMESERIES",
    "TimeSeriesStore",
    "timeseries_sample",
    "CapacitySignals",
    "AlertEngine",
    "AlertRule",
    "default_rules",
    "critical_path",
    "compare_critical_paths",
    "export_trace",
    "to_perfetto",
    "to_otlp",
    "TRACER",
    "Tracer",
    "TRACE_HEADER",
    "PARENT_HEADER",
    "span",
    "record_phase",
    "activate",
    "use_tracer",
    "active_tracer",
    "current_trace_id",
    "current_span_id",
    "new_trace_id",
    "process_token",
    "flush_journal",
]
