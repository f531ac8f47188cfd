"""Typed, layered configuration system.

One dataclass hierarchy resolved as: defaults <- config file (JSON/YAML)
<- environment variables (``TPUML_SECTION__FIELD``) <- explicit overrides.
The sections and defaults are the subset of the JAX package's
``utils/config.py`` that the ported runtime reads: storage, the placement
engine's knobs (``SchedulerConfig``), execution, and the service's REST,
admission and client-retry fields.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Optional

_ENV_PREFIX = "TPUML_"


@dataclasses.dataclass
class StorageConfig:
    """Filesystem layout: ``<root>/datasets/<id>/*.csv`` with a
    ``preprocessed/`` subdirectory, ``<root>/configs/<id>/*.yaml``
    preprocessing configs, ``<root>/models/<subtask_id>_model.pkl`` winner
    artifacts (runtime/artifacts.py), plus the job journal."""

    root: str = os.path.expanduser("~/.tpuml")

    @property
    def datasets_dir(self) -> str:
        return os.path.join(self.root, "datasets")

    @property
    def configs_dir(self) -> str:
        return os.path.join(self.root, "configs")

    @property
    def models_dir(self) -> str:
        return os.path.join(self.root, "models")

    @property
    def journal_dir(self) -> str:
        return os.path.join(self.root, "journal")

    @property
    def runtime_model_path(self) -> str:
        """The runtime predictor's fitted stages (runtime/predictor.py), an
        ``.npz`` of the port's own; the JAX package keeps a joblib pickle."""
        return os.path.join(self.root, "runtime_predictor.npz")


@dataclasses.dataclass
class SchedulerConfig:
    """Placement-engine knobs, with the JAX package's defaults."""

    heartbeat_interval_s: float = 5.0
    dead_after_s: float = 10.0
    sweep_interval_s: float = 15.0
    predictor_refit_batch: int = 10
    default_mem_capacity_mb: float = 16000.0
    speed_ema_alpha: float = 0.2
    speed_factor_min: float = 0.2
    speed_factor_max: float = 5.0
    algo_weights: dict = dataclasses.field(default_factory=dict)
    # ---- per-worker health telemetry ----
    # EWMA smoothing for a worker's batch wall time
    health_ema_alpha: float = 0.2
    # a worker is a straggler when its batch EWMA exceeds factor x the
    # median EWMA of its peers, after at least min_batches batches
    straggler_factor: float = 3.0
    straggler_min_batches: int = 2
    # advisory placement-score penalty (seconds) added to flagged stragglers
    straggler_penalty_s: float = 30.0
    # ---- fault tolerance ----
    # every placed subtask carries a lease: deadline = now +
    # max(lease_floor_s, lease_factor x predicted completion time on the
    # chosen worker, queue wait included). factor <= 0 disables.
    lease_factor: float = 4.0
    lease_floor_s: float = 30.0
    # total execution attempts per subtask before quarantine
    retry_max_attempts: int = 3
    # per-attempt backoff before a failure retry: retry_backoff_s x
    # 2^(failures-1), capped at retry_backoff_max_s
    retry_backoff_s: float = 0.5
    retry_backoff_max_s: float = 10.0
    # a subtask that killed this many worker backends is poisoned
    poison_kill_threshold: int = 2
    # speculative execution: one duplicate of a straggling subtask on an
    # idle worker; first terminal result wins
    speculative_enabled: bool = True
    speculative_min_inflight_s: float = 10.0
    # worker circuit breaker (ratio <= 0 disables)
    breaker_failure_ratio: float = 0.5
    breaker_min_outcomes: int = 4
    breaker_max_trips: int = 3
    # QoS lane aging: a waiting message is promoted one lane per
    # qos_aging_s seconds of queue age (<= 0: strict priority)
    qos_aging_s: float = 30.0


@dataclasses.dataclass
class ExecutionConfig:
    """Trial-execution knobs."""

    # max trials fused into one batched dispatch on the generic path
    max_trials_per_batch: int = 256
    # cv defaults matching sklearn cross_val_score(cv=5)
    default_cv_folds: int = 5
    default_test_size: float = 0.2


@dataclasses.dataclass
class ServiceConfig:
    """The coordinator's REST endpoint, the event stream's tick, admission
    control, the client's waiting and retry knobs, and the
    numerical-health watchdog's threshold."""

    host: str = "0.0.0.0"
    port: int = 5001
    # the tick between progress snapshots of Coordinator.stream_status
    sse_tick_s: float = 1.5
    client_poll_s: float = 1.0
    client_timeout_s: float = 600.0
    # ---- admission control: a submit past any cap is rejected with 429 +
    # Retry-After. <= 0 disables the cap.
    max_inflight_jobs: int = 64
    max_inflight_jobs_per_session: int = 16
    # total pending subtasks across unfinished jobs
    admission_queue_watermark: int = 50000
    # Retry-After seconds sent with 429 (admission) and 503 (recovering)
    admission_retry_after_s: float = 5.0
    # above this fraction of any cap the engine sheds optional work
    # (speculative duplicates) before admission rejects
    shed_fraction: float = 0.8
    # how long MLTaskManager(url=...) retries an idempotent request
    # through 429/503/connection errors (0 disables retries)
    request_retry_s: float = 60.0
    # the watchdog's rule (obs/curves.py::divergence): a trial diverges when
    # its loss / grad-norm trace tail exceeds this factor times the median
    # of its own early quarter, or any sample is non-finite
    curve_divergence_factor: float = 1e3
    # ---- the fleet health plane: capacity signals (obs/signals.py) and
    # SLO alert rules (obs/slo.py). The engine sweep, /metrics/prom
    # scrapes and /alerts / /autoscale reads all drive evaluation; these
    # floors keep the drivers from evaluating more often
    autoscale_interval_s: float = 5.0
    alert_eval_interval_s: float = 5.0
    # desired_workers is sized so the predictor-priced backlog drains
    # within this horizon (also the rejection-rate window)
    autoscale_horizon_s: float = 120.0
    autoscale_min_workers: int = 1
    autoscale_max_workers: int = 256
    # desired_shards targets this fill fraction of the admission caps
    autoscale_target_fill: float = 0.7
    # scale-down hysteresis: a below-live signal must hold this long
    autoscale_downscale_hold_s: float = 180.0
    # the SLO targets of the default alert rules
    route_p99_slo_s: float = 2.0
    sse_lag_slo_s: float = 5.0
    alert_admission_reject_per_s: float = 0.2
    # ---- cross-shard rebalancing: job migration and work stealing, driven
    # by the shard pressure signal (obs/signals.py). Off unless enabled,
    # even with peers wired (the peer routes still answer)
    rebalance_enabled: bool = False
    # floor between rebalance passes (each pass probes its peers)
    rebalance_interval_s: float = 10.0
    # at or above this pressure a shard is hot: it offers steal candidates
    # and looks for a cold peer to migrate a job to
    rebalance_hot_pressure: float = 2.0
    # at or below it a peer is a migration destination, and a shard with
    # idle workers turns thief
    rebalance_cold_pressure: float = 0.5
    # hot/cold pressure ratio floor before a migration fires
    rebalance_imbalance_ratio: float = 3.0
    # how long the donor relays late results of a migrated job
    rebalance_forward_s: float = 120.0
    # queued subtasks one steal grant hands a thief shard at most
    steal_max_tasks: int = 8
    # a steal tombstone older than this with no result is reclaimed
    steal_lease_s: float = 120.0


@dataclasses.dataclass
class FrameworkConfig:
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    service: ServiceConfig = dataclasses.field(default_factory=ServiceConfig)

    @classmethod
    def load(cls, path: Optional[str] = None, env: Optional[dict] = None,
             **overrides: Any) -> "FrameworkConfig":
        cfg = cls()
        if path:
            cfg = cfg.merged(_read_config_file(path))
        cfg = cfg.merged(_env_overrides(env if env is not None else os.environ))
        if overrides:
            cfg = cfg.merged(overrides)
        return cfg

    def merged(self, updates: dict) -> "FrameworkConfig":
        return _merge_dataclass(self, updates)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _merge_dataclass(obj, updates: dict):
    if not dataclasses.is_dataclass(obj):
        return updates
    kwargs = {}
    for f in dataclasses.fields(obj):
        cur = getattr(obj, f.name)
        if f.name in updates:
            upd = updates[f.name]
            if dataclasses.is_dataclass(cur) and isinstance(upd, dict):
                kwargs[f.name] = _merge_dataclass(cur, upd)
            else:
                kwargs[f.name] = upd
        else:
            kwargs[f.name] = cur
    return type(obj)(**kwargs)


def _read_config_file(path: str) -> dict:
    text = Path(path).read_text()
    if path.endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(text) or {}
    return json.loads(text)


def _env_overrides(env) -> dict:
    """TPUML_SECTION__FIELD=value -> {"section": {"field": parsed}}. Keys
    naming a section or field this package lacks are dropped by the merge."""
    out: dict = {}
    for key, raw in env.items():
        if not key.startswith(_ENV_PREFIX):
            continue
        parts = key[len(_ENV_PREFIX):].lower().split("__")
        if len(parts) != 2:
            continue
        section, field = parts
        try:
            value: Any = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            value = raw
        out.setdefault(section, {})[field] = value
    return out


_GLOBAL_CONFIG: Optional[FrameworkConfig] = None


def get_config() -> FrameworkConfig:
    global _GLOBAL_CONFIG
    if _GLOBAL_CONFIG is None:
        _GLOBAL_CONFIG = FrameworkConfig.load()
    return _GLOBAL_CONFIG


def set_config(cfg: FrameworkConfig) -> None:
    global _GLOBAL_CONFIG
    _GLOBAL_CONFIG = cfg
