"""Observability facade: the counter registry and the flight recorder.

The ported subset of the JAX package's ``obs/__init__.py``: the counter
registry (``.metrics``), the flight recorder's event journal
(``.recorder``) and the valve-gated counter the runtime calls.
``CS230_OBS=0`` turns both into near-free no-ops (one env read). Spans,
SLOs, gauges, histograms, export and device profiling are not ported yet.
"""

from __future__ import annotations

from .metrics import REGISTRY  # noqa: F401 — re-exported API
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
