"""Declarative SLO alert rules over the embedded time-series rings.

A copy of the JAX package's ``obs/slo.py`` (framework-free).

Nothing in this repo ever *consumed* its telemetry: RED metrics, the
flight recorder, and the per-series history rings all existed, but no
alert fired and no operator was paged. This module closes that loop
coordinator-side (fleets here often run with no external Prometheus or
Alertmanager at all — the same reasoning that put the time-series store
in-process, obs/timeseries.py):

- :class:`AlertRule` — one declarative rule against a counter/gauge
  family sampled into ``obs.timeseries.TIMESERIES``. Three kinds:

  * ``threshold``   — latest gauge value (max across matching series,
    stale series ignored) compared against ``threshold``;
  * ``burn_rate``   — multi-window burn rate (SRE workbook ch. 5): the
    counter's per-second rate over a SHORT and a LONG window must BOTH
    breach — the short window proves the burn is current, the long one
    proves it is significant, so a single blip neither fires nor does a
    sustained burn hide behind an old quiet period;
  * ``increase``    — any counter increase above ``threshold`` within
    one window (never-silent counters like
    ``tpuml_stage_cache_overflow_total`` whose doc row says "Alert on
    this counter").

- :class:`AlertEngine` — evaluates the rule set (throttled; the engine
  sweep, every ``/metrics/prom`` scrape, and ``GET /alerts`` all drive
  it), runs the ok -> pending(``for_s``) -> firing -> ok state machine,
  and journals every transition as an ``alert.fire`` / ``alert.resolve``
  flight-recorder event plus ``tpuml_alert_firing{rule=}`` /
  ``tpuml_alerts_fired_total`` metrics, so an incident is reconstructable
  from the same ``/events`` feed as everything else.

- :func:`default_rules` — the shipped ruleset: admission 429 rate, route
  p99 SLO, SSE delivery lag, worker breaker trips, and stage-budget
  overflow (docs/OBSERVABILITY.md "Fleet health plane").

Because rules read the RINGS (not the live registry), they can only
target counter/gauge families — which is exactly what the rings sample;
histogram-derived SLOs ride the derived gauges the scrape refreshes
(``tpuml_http_route_p99_seconds``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .metrics import REGISTRY
from .recorder import record_event
from .timeseries import TIMESERIES, timeseries_sample
from .tracing import _enabled

__all__ = [
    "AlertRule",
    "AlertEngine",
    "default_rules",
    "windowed_increase",
    "windowed_rate",
    "latest_value",
]


# ---------------- ring primitives ----------------


def _match(labels: Dict[str, str], want: Optional[Dict[str, Any]]) -> bool:
    """Subset match: every wanted key must be present; a wanted value may
    be a single string or a collection of acceptable strings."""
    if not want:
        return True
    for k, v in want.items():
        got = labels.get(k)
        if isinstance(v, (list, tuple, set, frozenset)):
            if got not in v:
                return False
        elif got != v:
            return False
    return True


def _series(
    name: str, labels: Optional[Dict[str, Any]] = None, store=None
) -> List[List[Tuple[float, float]]]:
    store = store or TIMESERIES
    out = []
    for s in store.history(name):
        if not _match(s.get("labels") or {}, labels):
            continue
        if s.get("samples"):
            out.append([(ts, v) for ts, v in s["samples"]])
    return out


def latest_value(
    name: str,
    labels: Optional[Dict[str, Any]] = None,
    *,
    now: Optional[float] = None,
    max_age_s: Optional[float] = None,
    store=None,
) -> Optional[float]:
    """Max over matching series' newest samples. ``max_age_s`` drops
    STALE series — a gauge cell the registry already removed (an evicted
    worker's breaker state) keeps its old samples in the ring forever,
    and an alert must not stay pinned to a worker that no longer
    exists."""
    now = time.time() if now is None else now
    best: Optional[float] = None
    for samples in _series(name, labels, store=store):
        ts, v = samples[-1]
        if max_age_s is not None and now - ts > max_age_s:
            continue
        best = v if best is None else max(best, v)
    return best


def windowed_increase(
    name: str,
    window_s: float,
    *,
    now: Optional[float] = None,
    labels: Optional[Dict[str, Any]] = None,
    store=None,
) -> Tuple[Optional[float], float]:
    """Summed counter increase over the trailing window across matching
    series, reset-clamped (a restart's drop to zero counts the new value,
    never a negative delta). Returns ``(increase, coverage_s)`` where
    coverage is how much of the window the samples actually span — young
    series (the flood that JUST started) get rated over the real elapsed
    time, not diluted across an empty window. ``(None, 0)`` when no
    matching series has any sample."""
    now = time.time() if now is None else now
    cutoff = now - window_s
    total: Optional[float] = None
    coverage = 0.0
    for samples in _series(name, labels, store=store):
        prior = None
        inwin: List[Tuple[float, float]] = []
        for ts, v in samples:
            if ts < cutoff:
                prior = (ts, v)
            else:
                inwin.append((ts, v))
        if prior is None and not inwin:
            continue
        # baseline: the last pre-window sample; absent one, the series was
        # born inside the window and counters are born at zero
        prev = prior[1] if prior is not None else 0.0
        inc = 0.0
        for _, v in inwin:
            inc += (v - prev) if v >= prev else v
            prev = v
        total = inc if total is None else total + inc
        first_ts = prior[0] if prior is not None else (
            inwin[0][0] if inwin else now
        )
        coverage = max(coverage, min(now - first_ts, window_s))
    return total, coverage


def windowed_rate(
    name: str,
    window_s: float,
    *,
    now: Optional[float] = None,
    labels: Optional[Dict[str, Any]] = None,
    store=None,
) -> Optional[float]:
    """Per-second counter rate over the trailing window (see
    :func:`windowed_increase` for partial-window semantics)."""
    inc, coverage = windowed_increase(
        name, window_s, now=now, labels=labels, store=store
    )
    if inc is None:
        return None
    return inc / max(coverage, 1.0)


# ---------------- rules ----------------


@dataclasses.dataclass
class AlertRule:
    """One declarative rule. ``labels`` filters series (subset match;
    values may be collections of acceptable strings). ``for_s`` delays
    firing until the breach has held that long (pending state).
    ``windows_s``: (short, long) for ``burn_rate``, (window,) for
    ``increase``; ignored by ``threshold``. ``max_age_s`` is the
    staleness cutoff for ``threshold`` rules (see latest_value)."""

    name: str
    metric: str
    kind: str = "threshold"  # threshold | burn_rate | increase
    threshold: float = 0.0
    cmp: str = ">"  # > | >= | < | <=
    windows_s: Sequence[float] = (60.0, 300.0)
    for_s: float = 0.0
    labels: Optional[Dict[str, Any]] = None
    max_age_s: float = 120.0
    severity: str = "page"  # page | warn
    description: str = ""

    def value(self, now: float, store=None) -> Optional[float]:
        """The rule's current evaluated value (None = no data, never a
        breach). burn_rate returns the SHORT-window rate but only breaches
        when both windows do (see breached)."""
        if self.kind == "threshold":
            return latest_value(
                self.metric, self.labels, now=now,
                max_age_s=self.max_age_s, store=store,
            )
        if self.kind == "increase":
            inc, _ = windowed_increase(
                self.metric, float(self.windows_s[0]), now=now,
                labels=self.labels, store=store,
            )
            return inc
        if self.kind == "burn_rate":
            return windowed_rate(
                self.metric, float(self.windows_s[0]), now=now,
                labels=self.labels, store=store,
            )
        raise ValueError(f"unknown rule kind {self.kind!r}")

    def _cmp(self, v: float) -> bool:
        if self.cmp == ">":
            return v > self.threshold
        if self.cmp == ">=":
            return v >= self.threshold
        if self.cmp == "<":
            return v < self.threshold
        if self.cmp == "<=":
            return v <= self.threshold
        raise ValueError(f"unknown cmp {self.cmp!r}")

    def breached(self, now: float, store=None) -> Tuple[bool, Optional[float]]:
        v = self.value(now, store=store)
        if v is None:
            return False, None
        if not self._cmp(v):
            return False, v
        if self.kind == "burn_rate" and len(self.windows_s) > 1:
            # multi-window: the long window must burn too
            long_rate = windowed_rate(
                self.metric, float(self.windows_s[1]), now=now,
                labels=self.labels, store=store,
            )
            if long_rate is None or not self._cmp(long_rate):
                return False, v
        return True, v

    def spec(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["windows_s"] = list(self.windows_s)
        return out


class AlertEngine:
    """Evaluates a rule set against the rings; journals transitions.

    State machine per rule: ok -> (breach) -> pending [for_s] -> firing
    -> (clear) -> ok. Fire and resolve transitions emit ``alert.fire`` /
    ``alert.resolve`` flight-recorder events (journaled with everything
    else), bump ``tpuml_alerts_fired_total`` / ``_resolved_total``, and
    drive the ``tpuml_alert_firing{rule=}`` gauge the rings then sample —
    an alert's own history is inspectable like any other series."""

    def __init__(
        self, rules: Iterable[AlertRule], *, interval_s: float = 5.0
    ):
        self.rules: List[AlertRule] = list(rules)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._state: Dict[str, Dict[str, Any]] = {
            r.name: {"state": "ok", "since": None, "value": None}
            for r in self.rules
        }
        self._last_eval = 0.0
        self._store = None  # test injection point (defaults to TIMESERIES)

    # ---------------- evaluation ----------------

    def evaluate(
        self, *, now: Optional[float] = None, force: bool = False
    ) -> bool:
        """One evaluation pass. Throttled by ``interval_s`` so the sweep,
        the scrape, and /alerts reads don't triple-evaluate; returns
        whether a pass actually ran."""
        wall = time.time()
        now = wall if now is None else now
        with self._lock:
            if not force and wall - self._last_eval < self.interval_s:
                return False
            self._last_eval = wall
        if _enabled():
            # rules read the rings: make sure this instant is sampled
            # (itself throttled — a no-op when the sweep just sampled)
            timeseries_sample()
        for rule in self.rules:
            try:
                breach, value = rule.breached(now, store=self._store)
            except Exception:  # noqa: BLE001 — one bad rule must not mute the rest
                continue
            self._transition(rule, breach, value, now)
        return True

    def _transition(
        self, rule: AlertRule, breach: bool, value: Optional[float],
        now: float,
    ) -> None:
        with self._lock:
            st = self._state[rule.name]
            st["value"] = value
            prev = st["state"]
            if breach:
                if prev == "ok":
                    if rule.for_s > 0:
                        st["state"], st["since"] = "pending", now
                        return
                    self._fire(rule, st, value, now)
                elif prev == "pending":
                    if now - (st["since"] or now) >= rule.for_s:
                        self._fire(rule, st, value, now)
                # firing stays firing (value refreshed above)
            else:
                if prev == "firing":
                    self._resolve(rule, st, value, now)
                elif prev == "pending":
                    st["state"], st["since"] = "ok", None

    def _fire(
        self, rule: AlertRule, st: Dict[str, Any], value, now: float
    ) -> None:
        st["state"], st["since"] = "firing", now
        if _enabled():
            REGISTRY.gauge("tpuml_alert_firing").set(1.0, rule=rule.name)
            REGISTRY.counter("tpuml_alerts_fired_total").inc(rule=rule.name)
        record_event(
            "alert.fire", rule=rule.name, severity=rule.severity,
            metric=rule.metric, rule_kind=rule.kind,
            value=None if value is None else round(float(value), 6),
            threshold=rule.threshold, description=rule.description,
        )

    def _resolve(
        self, rule: AlertRule, st: Dict[str, Any], value, now: float
    ) -> None:
        fired_at = st["since"]
        st["state"], st["since"] = "ok", None
        if _enabled():
            REGISTRY.gauge("tpuml_alert_firing").set(0.0, rule=rule.name)
            REGISTRY.counter("tpuml_alerts_resolved_total").inc(
                rule=rule.name
            )
        record_event(
            "alert.resolve", rule=rule.name, severity=rule.severity,
            metric=rule.metric,
            value=None if value is None else round(float(value), 6),
            firing_s=(
                None if fired_at is None else round(now - fired_at, 3)
            ),
        )

    # ---------------- reading ----------------

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(
                name for name, st in self._state.items()
                if st["state"] == "firing"
            )

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /alerts`` body: one entry per rule with its live
        state, plus the firing shortlist."""
        now = time.time()
        alerts = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule.name]
                alerts.append({
                    "rule": rule.name,
                    "state": st["state"],
                    "value": st["value"],
                    "threshold": rule.threshold,
                    "cmp": rule.cmp,
                    "metric": rule.metric,
                    "kind": rule.kind,
                    "windows_s": list(rule.windows_s),
                    "severity": rule.severity,
                    "since": st["since"],
                    "for_s": (
                        None if st["since"] is None
                        else round(now - st["since"], 3)
                    ),
                    "description": rule.description,
                })
        firing = [a["rule"] for a in alerts if a["state"] == "firing"]
        return {
            "status": "firing" if firing else "ok",
            "n_rules": len(alerts),
            "firing": firing,
            "alerts": alerts,
            "ts": now,
        }


#: poll/submit routes the control-plane p99 SLO covers — NOT the
#: deliberately-blocking ones (long-poll /next_tasks, SSE /train_status,
#: ?wait= holds on /metrics, bulk /dataset /download_* transfers), whose
#: latency is their contract, not a breach
_SLO_ROUTES = (
    "health", "healthz", "check_status", "jobs", "workers", "queues",
    "create_session", "train", "subscribe", "heartbeat", "events",
)


def default_rules(config=None) -> List[AlertRule]:
    """The shipped ruleset (docs/OBSERVABILITY.md "Fleet health plane").
    Thresholds come from ``ServiceConfig`` so a deployment tunes SLOs in
    config, not code."""
    if config is None:
        from ..utils.config import get_config

        config = get_config()
    svc = config.service
    return [
        AlertRule(
            name="admission_reject_rate",
            metric="tpuml_jobs_rejected_total",
            kind="burn_rate",
            threshold=svc.alert_admission_reject_per_s,
            windows_s=(30.0, 120.0),
            severity="page",
            description="Admission control is rejecting submits (429) "
                        "faster than the SLO burn budget on both the "
                        "30 s and 120 s windows — the fleet is saturated "
                        "or a client is flooding.",
        ),
        AlertRule(
            name="route_p99_slo",
            metric="tpuml_http_route_p99_seconds",
            kind="threshold",
            threshold=svc.route_p99_slo_s,
            labels={"route": list(_SLO_ROUTES)},
            for_s=10.0,
            severity="page",
            description="Control-plane p99 latency above the SLO on a "
                        "poll/submit route (blocking routes excluded).",
        ),
        AlertRule(
            name="sse_lag",
            metric="tpuml_sse_lag_seconds",
            kind="threshold",
            threshold=svc.sse_lag_slo_s,
            for_s=10.0,
            severity="warn",
            description="SSE progress events are delivered late beyond "
                        "the stream's tick cadence.",
        ),
        AlertRule(
            name="worker_breaker_trips",
            metric="tpuml_worker_breaker_state",
            kind="threshold",
            threshold=0.5,
            cmp=">=",
            severity="warn",
            description="At least one worker's circuit breaker is "
                        "half-open (failure ratio above the trip "
                        "threshold) — capacity is degraded while it "
                        "proves itself or gets evicted.",
        ),
        AlertRule(
            name="stage_cache_overflow",
            metric="tpuml_stage_cache_overflow_total",
            kind="increase",
            threshold=0.0,
            windows_s=(300.0,),
            severity="page",
            description="The stage cache overflowed its device-memory "
                        "budget (every LRU survivor pinned, or "
                        "CS230_STAGE_STRICT refused an upload) within "
                        "the last 5 minutes — the never-silent OOM "
                        "counter docs tell operators to alert on.",
        ),
    ]
