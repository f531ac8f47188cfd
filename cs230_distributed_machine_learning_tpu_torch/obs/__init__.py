"""Observability facade: the metrics registry and the flight recorder.

The ported subset of the JAX package's ``obs/__init__.py``: the metrics
registry (``.metrics``: counters, gauges, histograms, the Prometheus text
rendering), the flight recorder's event journal (``.recorder``) and the
valve-gated helpers the runtime calls. ``CS230_OBS=0`` turns them into
near-free no-ops (one env read). Spans, SLOs, the time series, export and
device profiling are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .metrics import REGISTRY, Gauge, Histogram  # noqa: F401 — re-exported API
from .recorder import RECORDER, record_event  # noqa: F401
from .tracing import _enabled as _valve
from .tracing import flush_journal  # noqa: F401


def obs_enabled() -> bool:
    """The master valve, read per call so ``CS230_OBS`` can be flipped on a
    live process."""
    return _valve()


def counter_inc(name: str, amount: float = 1.0, **labels: str) -> None:
    if not obs_enabled():
        return
    REGISTRY.counter(name).inc(amount, **labels)


def gauge_set(name: str, value: float, **labels: str) -> None:
    if not obs_enabled():
        return
    REGISTRY.gauge(name).set(value, **labels)


def observe(name: str, value: float, buckets: Optional[Sequence[float]] = None,
            **labels: str) -> None:
    if not obs_enabled():
        return
    if buckets is not None:
        REGISTRY.histogram(name, buckets=buckets).observe(value, **labels)
    else:
        REGISTRY.histogram(name).observe(value, **labels)


def render_prometheus() -> str:
    return REGISTRY.render()


def process_token() -> str:
    """``host:pid`` of this process: a remote message carrying it names
    the process that already counted its outcome into this registry (an
    agent sharing the coordinator's process)."""
    import os
    import socket

    return f"{socket.gethostname()}:{os.getpid()}"
