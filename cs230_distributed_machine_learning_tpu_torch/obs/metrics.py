"""Thread-safe in-process metrics registry with Prometheus text exposition.

A copy of the JAX package's ``obs/metrics.py`` (framework-free): counters,
gauges and fixed-bucket histograms that every runtime layer (coordinator,
scheduler, cluster, executor, REST server) writes in place through the
``obs`` facade (``obs/__init__.py``), which checks the ``CS230_OBS`` valve
before it touches the registry. ``render()`` is the Prometheus text format
v0.0.4: ``# HELP``/``# TYPE`` per family; histograms emit cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``. Each metric guards its
label-keyed cells with one lock, since job threads, worker loops and the
HTTP server's request threads write concurrently.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: default latency buckets (seconds) — spans sub-ms placement decisions
#: through multi-minute compiles
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

#: finer buckets for the placement decision (lock + min over workers:
#: microseconds on small pools)
PLACEMENT_BUCKETS: Tuple[float, ...] = (
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
)

#: control-plane request-latency buckets (seconds) — finer sub-ms low end
#: than DEFAULT_BUCKETS (health polls and queue reads sit there), topping
#: out at 30 s (an SSE stream's first byte under a slow job)
HTTP_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

#: dimensionless relative-error buckets for predictor calibration
#: (|predicted - actual| / actual): 0.05 = within 5%, 10 = off by 10x —
#: the range spans a well-calibrated predictor through a cold-started one
CALIBRATION_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0,
    30.0, 100.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline) — a label value fed from a wire message (e.g. a remote
    agent's ``algo``) must not be able to break the whole scrape."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: LabelKey, extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(key) + ([extra] if extra else [])
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in items
    )
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonic counter, optionally labeled. Values are floats (Prometheus
    counters are)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def cells(self) -> List[Tuple[Dict[str, str], float]]:
        """Snapshot of every labeled cell as (labels, value) — the
        time-series sampler's read path (obs/timeseries.py)."""
        with self._lock:
            return [(dict(key), v) for key, v in self._values.items()]

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} counter",
        ]
        with self._lock:
            cells = sorted(self._values.items()) or [((), 0.0)]
        for key, v in cells:
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return out


class Gauge:
    """Last-written value, optionally labeled."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def remove(self, **labels: str) -> None:
        """Drop one labeled cell — a gauge keyed by worker id must not keep
        exposing a dead/unsubscribed worker forever."""
        with self._lock:
            self._values.pop(_label_key(labels), None)

    def labelsets(self) -> List[Dict[str, str]]:
        """Current label sets with a live cell (introspection/tests)."""
        with self._lock:
            return [dict(key) for key in self._values]

    def cells(self) -> List[Tuple[Dict[str, str], float]]:
        """Snapshot of every labeled cell as (labels, value) — the
        time-series sampler's read path (obs/timeseries.py)."""
        with self._lock:
            return [(dict(key), v) for key, v in self._values.items()]

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
        ]
        with self._lock:
            cells = sorted(self._values.items()) or [((), 0.0)]
        for key, v in cells:
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return out


class Histogram:
    """Fixed-bucket histogram. Buckets are upper bounds (seconds for the
    latency families); observations land in every bucket whose bound is
    >= the value — the cumulative Prometheus semantics are computed at
    render so the hot path is one bisect + two adds."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        # per label-set: ([per-bucket non-cumulative counts] + [overflow],
        #                 sum, count)
        self._cells: Dict[LabelKey, List] = {}

    def observe(self, value: float, **labels: str) -> None:
        import bisect

        value = float(value)
        key = _label_key(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._cells[key] = cell
            cell[0][i] += 1
            cell[1] += value
            cell[2] += 1

    def count(self, **labels: str) -> int:
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            return cell[2] if cell else 0

    def _interpolate(self, counts: List[int], n: int, q: float) -> float:
        """Bucket-interpolated quantile (the standard Prometheus
        ``histogram_quantile`` semantics, computed in-process): find the
        bucket the q-th observation falls in and interpolate linearly
        inside it. Observations above the top bound clamp to it (the
        +Inf bucket has no interpolable width)."""
        rank = min(max(float(q), 0.0), 1.0) * n
        cum = 0
        for i, cnt in enumerate(counts[: len(self.buckets)]):
            prev = cum
            cum += cnt
            if cum >= rank and cnt > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * (rank - prev) / cnt
        return float(self.buckets[-1])

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Quantile estimate for one exact label set; None when empty."""
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            if cell is None or cell[2] == 0:
                return None
            counts, n = list(cell[0]), cell[2]
        return self._interpolate(counts, n, q)

    def quantile_where(self, q: float, **match: str) -> Optional[float]:
        """Quantile over the MERGE of every cell whose labels include
        ``match`` — e.g. ``quantile_where(0.99, route="health")`` pools
        methods and status codes into one per-route estimate (the SLO
        layer's route-p99 gauge refresh). None when nothing matches."""
        want = set((str(k), str(v)) for k, v in match.items())
        merged: Optional[List[int]] = None
        n = 0
        with self._lock:
            for key, (counts, _s, c) in self._cells.items():
                if not want <= set(key):
                    continue
                if merged is None:
                    merged = list(counts)
                else:
                    merged = [a + b for a, b in zip(merged, counts)]
                n += c
        if merged is None or n == 0:
            return None
        return self._interpolate(merged, n, q)

    def labelsets(self) -> List[Dict[str, str]]:
        """Label sets with a live cell — the route-p99 refresh walks
        these to know which routes have observations."""
        with self._lock:
            return [dict(key) for key in self._cells]

    def sum(self, **labels: str) -> float:
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            return cell[1] if cell else 0.0

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            cells = {
                key: ([*counts], s, c)
                for key, (counts, s, c) in sorted(self._cells.items())
            } or {(): ([0] * (len(self.buckets) + 1), 0.0, 0)}
        for key, (counts, total, n) in cells.items():
            cum = 0
            for bound, cnt in zip(self.buckets, counts):
                cum += cnt
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(key, ('le', _fmt_value(bound)))} {cum}"
                )
            out.append(
                f"{self.name}_bucket{_fmt_labels(key, ('le', '+Inf'))} {n}"
            )
            out.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        return out


class MetricsRegistry:
    """Name -> metric. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, so call sites need no registration
    ceremony); re-registering with a different kind raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Sequence[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        """Full Prometheus text exposition (v0.0.4), families in name order."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


#: the process-global registry every runtime layer writes to
REGISTRY = MetricsRegistry()
