"""Capacity signals: derive desired_workers / desired_shards from telemetry.

A copy of the JAX package's ``obs/signals.py`` (framework-free).

ROADMAP item 5(c): the observatory measures everything — RED route p99,
admission-queue depth, per-worker queue/load books, predictor-priced
backlog — but nothing ever turned those measurements into a capacity
decision. :class:`CapacitySignals` folds them into two gauges an
EXTERNAL autoscaler (deploy/) can act on:

- ``tpuml_autoscale_desired_workers`` — how many workers this shard
  should have. Sized so the predictor-priced backlog (every worker's
  load book is a sum of RuntimePredictor estimates, plus unplaced
  pending subtasks priced at the mean queued estimate) drains within
  ``autoscale_horizon_s``; bumped past the live count under PRESSURE
  (admission rejections within the window, an admission cap saturated,
  or route p99 over its SLO) because a fleet that is rejecting work or
  missing latency SLOs needs capacity regardless of what the backlog
  arithmetic says.
- ``tpuml_autoscale_desired_shards`` — how many coordinator shards the
  FLEET should run, sized so in-flight jobs sit at
  ``autoscale_target_fill`` of the (per-shard-carved) admission caps.

Hysteresis (the half that makes the signal actuatable): scale-UP
publishes immediately; scale-DOWN only after the raw signal has held
below the live count for ``autoscale_downscale_hold_s`` AND only as far
as the drain path can absorb — a worker is only removable when it is
idle (empty queue book), because removal drains through the existing
lease/evict/requeue machinery and yanking a loaded worker just converts
its queue into retries. Until both hold, the gauge reports the live
count and the ``GET /autoscale`` body says why (``scale_down_held``).

Driven by the engine sweep (cluster mode) and by ``/metrics/prom`` /
``/autoscale`` reads (direct mode has no sweep), throttled by
``autoscale_interval_s``. Fleet view: the front end sums per-shard
bodies at ``GET /autoscale`` (runtime/frontend.py).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Optional

from .metrics import REGISTRY, Gauge
from .slo import windowed_rate
from .tracing import _enabled

__all__ = ["CapacitySignals"]

#: routes whose latency is their contract (long-poll, SSE, bulk
#: transfer, ?wait= holds) — never a pressure signal
_NON_SLO_ROUTES = {
    "next_tasks", "train_status", "dataset", "download_data",
    "download_model", "metrics", "preprocess",
}


def _route_p99_worst(now: float, max_age_s: float = 120.0) -> float:
    """Worst per-route p99 from the derived gauge (live registry cells,
    not the rings: the deriver runs right after refresh_route_p99 on the
    same sweep/scrape, so the cells ARE current)."""
    g = REGISTRY.get("tpuml_http_route_p99_seconds")
    if not isinstance(g, Gauge):
        return 0.0
    worst = 0.0
    for labels, value in g.cells():
        if labels.get("route") in _NON_SLO_ROUTES:
            continue
        worst = max(worst, float(value))
    return worst


class CapacitySignals:
    """Per-coordinator capacity deriver. One instance per Coordinator;
    evaluation reads the job store, the placement engine's books, and
    the registry, and is cheap enough to run at scrape cadence."""

    def __init__(self, coordinator):
        self._coord = coordinator
        self._lock = threading.Lock()
        self._report: Optional[Dict[str, Any]] = None
        self._last_eval = 0.0
        #: hysteresis clocks: when the raw signal first dropped below the
        #: live count (None while at/above)
        self._workers_below_since: Optional[float] = None
        self._shards_below_since: Optional[float] = None

    # ---------------- evaluation ----------------

    def report(self) -> Dict[str, Any]:
        """Last derived report (evaluating first if none exists yet) —
        the ``GET /autoscale`` body."""
        with self._lock:
            rep = self._report
        if rep is None:
            return self.evaluate(force=True)
        return rep

    def evaluate(
        self, *, now: Optional[float] = None, force: bool = False
    ) -> Dict[str, Any]:
        coord = self._coord
        svc = coord.config.service
        wall = time.time()
        now = wall if now is None else now
        with self._lock:
            if (
                not force
                and self._report is not None
                and wall - self._last_eval < svc.autoscale_interval_s
            ):
                return self._report
            self._last_eval = wall

        counts = coord.store.unfinished_counts()
        engine = coord.cluster.engine if coord.cluster is not None else None
        workers = engine.worker_snapshot() if engine is not None else {}
        live = len(workers)
        total_devices = (
            engine.total_devices() if engine is not None else 0
        )
        queue_depth = sum(
            int(w.get("queue_depth") or 0) for w in workers.values()
        )
        #: the load books ARE the predictor's pricing: every queued task
        #: added est/speed_factor seconds at placement time
        backlog_s = sum(
            float(w.get("load_seconds") or 0.0) for w in workers.values()
        )
        backlog_device_s = sum(
            float(w.get("load_seconds") or 0.0)
            * max(int(w.get("n_devices") or 1), 1)
            for w in workers.values()
        )
        idle_workers = sorted(
            wid for wid, w in workers.items()
            if int(w.get("queue_depth") or 0) == 0
            and float(w.get("load_seconds") or 0.0) <= 1e-9
        )
        # unplaced pending subtasks (admitted but not yet on a worker's
        # book) priced at the mean queued estimate — the predictor has no
        # task spec for them yet, the fleet mean is the best prior
        avg_est = (backlog_s / queue_depth) if queue_depth else 1.0
        unplaced = max(int(counts["pending_subtasks"]) - queue_depth, 0)
        backlog_total_s = backlog_s + unplaced * avg_est

        # ---- pressure signals ----
        p99 = _route_p99_worst(now)
        util = 0.0
        if svc.max_inflight_jobs > 0:
            util = max(util, counts["jobs"] / svc.max_inflight_jobs)
        if svc.admission_queue_watermark > 0:
            util = max(
                util,
                counts["pending_subtasks"] / svc.admission_queue_watermark,
            )
        reject_rate = None
        if _enabled():
            reject_rate = windowed_rate(
                "tpuml_jobs_rejected_total", svc.autoscale_horizon_s,
                now=now,
            )
        pressure = bool(
            (reject_rate or 0.0) > 0.0
            or util >= 1.0
            or (svc.route_p99_slo_s > 0 and p99 > svc.route_p99_slo_s)
        )
        # numeric per-shard pressure (the migration/steal trigger,
        # docs/ROBUSTNESS.md "Shard rebalancing"): dimensionless sum of
        # (a) backlog expressed in drain-horizons, (b) admission-cap
        # utilization, (c) a flat +1 while the shard is BURNING 429s —
        # rejecting work is hot no matter what the backlog arithmetic
        # says. 0 ≈ idle, ≥1 ≈ busy, ≥rebalance_hot_pressure ≈ shed load.
        horizon_v = max(float(svc.autoscale_horizon_s), 1e-6)
        shard_pressure = round(
            backlog_total_s / horizon_v
            + util
            + (1.0 if (reject_rate or 0.0) > 0.0 else 0.0),
            4,
        )

        # ---- desired workers ----
        horizon = max(float(svc.autoscale_horizon_s), 1e-6)
        demand = int(math.ceil(backlog_total_s / horizon))
        raw_workers = max(demand, int(svc.autoscale_min_workers), 0)
        if pressure:
            step = max(1, int(math.ceil(live * 0.5))) if live else 1
            raw_workers = max(raw_workers, live + step)
        raw_workers = min(raw_workers, int(svc.autoscale_max_workers))
        desired_workers, workers_held = self._hold_down(
            "workers", raw_workers, live, len(idle_workers), now,
            svc.autoscale_downscale_hold_s,
        )

        # ---- desired shards ----
        n_shards = max(int(coord.n_shards), 1)
        fill = min(max(float(svc.autoscale_target_fill), 1e-6), 1.0)
        job_util = (
            counts["jobs"] / svc.max_inflight_jobs
            if svc.max_inflight_jobs > 0 else 0.0
        )
        if (reject_rate or 0.0) > 0.0:
            # rejecting == beyond full, whatever the instantaneous count
            job_util = max(job_util, 1.0)
        raw_shards = max(int(math.ceil(n_shards * job_util / fill)), 1)
        # shards drain through job completion, not worker eviction: the
        # only drain gate is the hold window (a shard removal is a
        # journal-replay takeover, always absorbable)
        desired_shards, shards_held = self._hold_down(
            "shards", raw_shards, n_shards, n_shards, now,
            svc.autoscale_downscale_hold_s,
        )

        if _enabled():
            g = REGISTRY.gauge
            g("tpuml_autoscale_desired_workers").set(float(desired_workers))
            g("tpuml_autoscale_desired_shards").set(float(desired_shards))
            g("tpuml_autoscale_backlog_seconds").set(
                float(backlog_total_s)
            )
            g("tpuml_shard_pressure").set(float(shard_pressure))

        rep: Dict[str, Any] = {
            "desired_workers": desired_workers,
            "live_workers": live,
            "desired_shards": desired_shards,
            "n_shards": n_shards,
            "signals": {
                "backlog_seconds": round(backlog_total_s, 3),
                "backlog_device_seconds": round(backlog_device_s, 3),
                "queued_subtasks": queue_depth,
                "unplaced_subtasks": unplaced,
                "pending_subtasks": int(counts["pending_subtasks"]),
                "inflight_jobs": int(counts["jobs"]),
                "admission_utilization": round(util, 4),
                "reject_rate_per_s": (
                    None if reject_rate is None else round(reject_rate, 4)
                ),
                "route_p99_s": round(p99, 4),
                "route_p99_slo_s": svc.route_p99_slo_s,
                "total_devices": total_devices,
                "idle_workers": len(idle_workers),
                "pressure": pressure,
                "shard_pressure": shard_pressure,
            },
            "hysteresis": {
                "raw_desired_workers": raw_workers,
                "scale_down_held": bool(workers_held),
                "shards_scale_down_held": bool(shards_held),
                "hold_s": svc.autoscale_downscale_hold_s,
                "drainable_workers": len(idle_workers),
            },
            "horizon_s": svc.autoscale_horizon_s,
            "ts": now,
        }
        if coord.shard_id is not None:
            rep["shard"] = coord.shard_id
        with self._lock:
            self._report = rep
        return rep

    def _hold_down(
        self, key: str, raw: int, live: int, drainable: int, now: float,
        hold_s: float,
    ) -> "tuple[int, bool]":
        """Scale-down hysteresis: below-live signals publish only after
        holding ``hold_s``, and only as deep as ``drainable`` allows.
        Returns (published_value, held)."""
        attr = f"_{key}_below_since"
        with self._lock:
            if raw >= live or live <= 0:
                setattr(self, attr, None)
                return raw, False
            below_since = getattr(self, attr)
            if below_since is None:
                setattr(self, attr, now)
                below_since = now
        held_for = now - below_since
        if held_for < hold_s or drainable <= 0:
            return live, True
        stepped = max(raw, live - drainable)
        return stepped, stepped > raw
