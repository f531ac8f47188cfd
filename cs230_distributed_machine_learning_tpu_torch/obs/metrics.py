"""Thread-safe in-process counter registry.

The counter part of the JAX package's ``obs/metrics.py`` (framework-free),
copied: labeled monotonic counters that the runtime increments in place
through the ``obs`` facade (``obs/__init__.py``), which checks the
``CS230_OBS`` valve before it touches the registry. Gauges, histograms
and the Prometheus text exposition (``GET /metrics/prom``) come with the
REST surface and observability (ROADMAP A2 and A4).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


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


class MetricsRegistry:
    """Name -> counter. ``counter`` is get-or-create (idempotent, so call
    sites need no registration ceremony)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help)
            return m


#: the process-global registry every runtime layer writes to
REGISTRY = MetricsRegistry()
