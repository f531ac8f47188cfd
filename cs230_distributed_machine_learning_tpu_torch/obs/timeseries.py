"""Embedded metrics time-series: a bounded in-memory ring per series.

A copy of the JAX package's ``obs/timeseries.py`` (framework-free).

The Prometheus exposition (``GET /metrics/prom``) is point-in-time: a
question like "was the retry rate climbing before the breaker tripped" or
"how deep did worker-1's queue get during the incident" needs HISTORY,
and fleets in this repo's deployments often run with no external
Prometheus at all (Monarch-style in-memory time series, PAPERS.md). So
the runtime keeps its own short history:

- :func:`sample` walks the registry's counters and gauges and appends
  ``(ts, value)`` to a ring per (name, label-set) series. It is driven by
  the placement engine's sweep loop (one sample per sweep — the cadence
  every other periodic decision already runs on) and by each
  ``/metrics/prom`` scrape, throttled by ``min_interval_s`` so the two
  drivers don't double-sample.
- ``GET /metrics/history?name=&since=`` serves a series' samples;
  ``/dashboard`` draws rate/sparkline panels from it (queue depth,
  retries/s, breaker states, MFU).

Bounds: ``max_samples`` per series (ring), ``max_series`` series total
(least-recently-written evicted). Histograms are not sampled — per-bucket
series would multiply the series count for little explanatory power; the
``_count``/``_sum`` of interest already exist as derived counters on the
exposition side.

Valve-gated by ``CS230_OBS`` like everything else in ``obs/``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import REGISTRY, Counter, Gauge
from .tracing import _enabled

#: samples kept per series (at the default 15 s sweep cadence: ~2 h)
_MAX_SAMPLES = 512
#: distinct (name, labels) series kept
_MAX_SERIES = 1024
#: floor between samples — the sweep and the scrape both drive sample()
_MIN_INTERVAL_S = 1.0

SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class TimeSeriesStore:
    def __init__(
        self,
        *,
        max_samples: int = _MAX_SAMPLES,
        max_series: int = _MAX_SERIES,
        min_interval_s: float = _MIN_INTERVAL_S,
    ):
        self._lock = threading.Lock()
        self._series: "collections.OrderedDict[SeriesKey, collections.deque]" = (
            collections.OrderedDict()
        )
        self._max_samples = max_samples
        self._max_series = max_series
        self.min_interval_s = min_interval_s
        self._last_sample = 0.0

    # ---------------- writing ----------------

    def sample(self, registry=None, *, now: Optional[float] = None, force: bool = False) -> int:
        """Record one sample of every counter/gauge cell in ``registry``.
        Returns how many series were touched (0 when disabled or
        throttled). ``force=True`` bypasses the throttle (tests and
        explicit operator refreshes)."""
        if not _enabled():
            return 0
        registry = registry or REGISTRY
        now = time.time() if now is None else now
        with self._lock:
            if not force and now - self._last_sample < self.min_interval_s:
                return 0
            self._last_sample = now
        n = 0
        for name in registry.names():
            metric = registry.get(name)
            if not isinstance(metric, (Counter, Gauge)):
                continue
            for labels, value in metric.cells():
                self._append(name, labels, now, value)
                n += 1
        return n

    def _append(
        self, name: str, labels: Dict[str, str], ts: float, value: float
    ) -> None:
        key: SeriesKey = (name, tuple(sorted(labels.items())))
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = collections.deque(maxlen=self._max_samples)
                self._series[key] = ring
                while len(self._series) > self._max_series:
                    self._series.popitem(last=False)
            else:
                self._series.move_to_end(key)
            ring.append((ts, value))

    # ---------------- reading ----------------

    def history(
        self, name: str, since: float = 0.0
    ) -> List[Dict[str, Any]]:
        """All series of family ``name``: [{labels, samples: [[ts, v]...]}]
        with samples newer than ``since`` (epoch seconds). Unknown names
        return an empty list — an unsampled family is absence of data, not
        an error."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for (n, labelkey), ring in self._series.items():
                if n != name:
                    continue
                samples = [[ts, v] for ts, v in ring if ts > since]
                out.append({"labels": dict(labelkey), "samples": samples})
        out.sort(key=lambda s: sorted(s["labels"].items()))
        return out

    def names(self) -> List[str]:
        """Sampled family names (the /metrics/history discovery list)."""
        with self._lock:
            return sorted({name for name, _ in self._series})

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)


#: the process-global store the sweep/scrape sample into
TIMESERIES = TimeSeriesStore()


def timeseries_sample(force: bool = False) -> int:
    """Sample the global registry into the global store (valve-gated,
    throttled). The placement-engine sweep and the /metrics/prom handler
    both call this."""
    return TIMESERIES.sample(REGISTRY, force=force)
