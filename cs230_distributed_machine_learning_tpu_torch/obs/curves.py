"""Trial telemetry plane: in-fit learning curves.

Port of the JAX package's ``obs/curves.py``, the shared vocabulary of the
curve pipeline:

* **Device side**: the solvers write one sample every
  ``trace_stride(steps)`` iterations into a fixed-size trace buffer
  (``curve_points()`` slots, default 64) with :func:`trace_update`.
* **Host side**: :func:`build_curve_record` trims the buffers to the
  populated prefix and emits the JSON-safe per-trial record that rides
  the result and metrics transport; :func:`divergence` is the
  numerical-health watchdog's rule; :func:`last_k_slope` feeds the
  curve-aware ASHA rung decision (``CS230_ASHA_CURVE=1``).
* **Coordinator side**: :class:`CurveStore` is the bounded
  per-(job, subtask, rung) store behind ``MLTaskManager.curves`` and the
  incremental ``curve`` events of ``Coordinator.stream_status``.

Valves, as in the JAX package:

``CS230_CURVES``
    ``auto`` (default, capture on) | ``0`` (no trace buffers, no curve
    leaves in the results).
``CS230_CURVE_POINTS``
    Trace buffer length (default 64, clamped to [4, 512]).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_POINTS_MIN = 4
_POINTS_MAX = 512


def curves_mode() -> str:
    """Current ``CS230_CURVES`` valve value (``auto`` or ``0``)."""
    v = os.environ.get("CS230_CURVES", "auto").strip().lower()
    return "0" if v in ("0", "off", "false") else "auto"


def curves_enabled() -> bool:
    return curves_mode() != "0"


def curve_points() -> int:
    """Trace buffer length; ``CS230_CURVE_POINTS`` clamped to [4, 512]."""
    try:
        p = int(os.environ.get("CS230_CURVE_POINTS", "64"))
    except ValueError:
        p = 64
    return max(_POINTS_MIN, min(_POINTS_MAX, p))


def curves_salt() -> tuple:
    """The valve and the buffer size, for keys of anything built per
    capture setting."""
    if not curves_enabled():
        return ("curves0",)
    return ("curves", curve_points())


def trace_stride(steps: int) -> int:
    """Sampling stride so a ``steps``-iteration solve fills at most
    ``curve_points()`` slots (``slot = t // stride``)."""
    steps = max(1, int(steps))
    return max(1, int(math.ceil(steps / float(curve_points()))))


def trace_update(buf, t: int, value, stride: int, *, active=None):
    """Write ``value`` into its slot of the trace buffer (last sample wins
    within a stride window), in place; returns ``buf``.

    ``buf``: f32 tensor ``[P, *value.shape]``; ``t``: the iteration index;
    ``active``: optional bool mask broadcastable to ``value.shape``, where
    inactive lanes keep their previous sample so the trace tail freezes
    at convergence.
    """
    import torch

    idx = int(t) // int(stride)
    if active is not None:
        value = torch.where(active, value, buf[idx])
    buf[idx] = value
    return buf


def _finite_list(arr) -> List[Optional[float]]:
    """JSON-safe float list: non-finite values become ``None``."""
    out: List[Optional[float]] = []
    for v in arr:
        f = float(v)
        out.append(f if math.isfinite(f) else None)
    return out


def build_curve_record(
    channels: Dict[str, Any],
    stride: int,
    steps: int,
    *,
    tail: Optional[Sequence[float]] = None,
) -> Dict[str, Any]:
    """Assemble the JSON-safe per-trial curve record from raw trace buffers.

    ``channels`` maps channel name (``gmax``) to an array shaped ``[S, P]``
    (splits x trace slots) or ``[P]``; buffers are trimmed to the populated
    prefix ``ceil(steps / stride)``. ``tail`` is the per-split final score,
    so the record is self-contained ("trace tail == final score").
    """
    import numpy as np

    used = max(1, int(math.ceil(max(1, int(steps)) / float(max(1, int(stride))))))
    rec: Dict[str, Any] = {"v": 1, "stride": int(stride), "steps": int(steps)}
    nonfinite = False
    for name, buf in channels.items():
        a = np.asarray(buf, dtype=np.float64)
        if a.ndim == 1:
            a = a[None, :]
        a = a[:, : min(used, a.shape[1])]
        nonfinite = nonfinite or bool(np.any(~np.isfinite(a)))
        rec[name] = [_finite_list(row) for row in a]
    if tail is not None:
        t = np.asarray(tail, dtype=np.float64).reshape(-1)
        nonfinite = nonfinite or bool(np.any(~np.isfinite(t)))
        rec["tail"] = _finite_list(t)
    rec["nonfinite"] = nonfinite
    return rec


def _rows(rec: Dict[str, Any], channel: str) -> List[List[Optional[float]]]:
    rows = rec.get(channel)
    if not isinstance(rows, list) or not rows:
        return []
    if rows and not isinstance(rows[0], list):
        rows = [rows]
    return rows


def divergence(rec: Dict[str, Any], factor: float) -> bool:
    """Watchdog rule: a trial is diverged when any channel contains a
    non-finite sample, or when the trace tail of ``loss``/``gmax``
    exceeds ``factor`` × the median of its own early quarter (at least
    4 early points required so short traces never trip)."""
    if not isinstance(rec, dict):
        return False
    if rec.get("nonfinite"):
        return True
    import numpy as np

    for channel in ("loss", "gmax"):
        for row in _rows(rec, channel):
            vals = [v for v in row if v is not None]
            if any(v is None for v in row):
                return True
            n = len(vals)
            early_n = max(1, n // 4)
            if early_n < 4:
                continue
            early = np.median(np.abs(np.asarray(vals[:early_n], dtype=np.float64)))
            tail = abs(float(vals[-1]))
            if early > 0 and tail > float(factor) * early:
                return True
            if early == 0 and tail > float(factor):
                return True
    return False


def last_k_slope(values: Iterable[Optional[float]], k: int = 8) -> float:
    """Least-squares slope (per trace point) over the last ``k`` finite
    samples; 0.0 when fewer than 2 samples are available."""
    vals = [float(v) for v in values if v is not None and math.isfinite(float(v))]
    if len(vals) < 2:
        return 0.0
    tail = vals[-max(2, int(k)):]
    n = len(tail)
    xs = list(range(n))
    mx = (n - 1) / 2.0
    my = sum(tail) / n
    num = sum((x - mx) * (y - my) for x, y in zip(xs, tail))
    den = sum((x - mx) ** 2 for x in xs)
    return num / den if den else 0.0


class CurveStore:
    """Bounded, thread-safe per-(job, subtask, rung) curve store.

    Entries are deduped on ``(subtask_id, rung, attempt)`` — a curve
    re-delivered through both the result and metrics transports (or a
    retried fetch) counts once.  A monotone per-store version counter
    supports incremental SSE (``updates(job_id, since)``).  Per-job
    entry count is capped (oldest evicted) so a long sweep cannot grow
    the coordinator without bound.
    """

    def __init__(self, max_entries_per_job: int = 4096, max_jobs: int = 64):
        self._lock = threading.Lock()
        self._jobs: Dict[str, Dict[Tuple[str, int, int], Dict[str, Any]]] = {}
        self._order: List[str] = []  # job LRU
        self._version = 0
        self.max_entries_per_job = int(max_entries_per_job)
        self.max_jobs = int(max_jobs)

    def ingest(
        self,
        job_id: str,
        subtask_id: str,
        curve: Dict[str, Any],
        *,
        rung: int = 0,
        attempt: int = 0,
        diverged: bool = False,
    ) -> int:
        """Store one curve.  Returns the number of NEW trace points
        ingested (0 when the (subtask, rung, attempt) key was already
        present — callers use this for ``tpuml_curve_points_total``)."""
        if not isinstance(curve, dict):
            return 0
        key = (str(subtask_id), int(rung or 0), int(attempt or 0))
        with self._lock:
            per = self._jobs.get(job_id)
            if per is None:
                per = self._jobs[job_id] = {}
                self._order.append(job_id)
                while len(self._order) > self.max_jobs:
                    old = self._order.pop(0)
                    self._jobs.pop(old, None)
            elif key in per:
                return 0
            else:
                # refresh job LRU position
                try:
                    self._order.remove(job_id)
                except ValueError:
                    pass
                self._order.append(job_id)
            self._version += 1
            entry = {
                "subtask_id": key[0],
                "rung": key[1],
                "attempt": key[2],
                "curve": curve,
                "diverged": bool(diverged),
                "version": self._version,
            }
            per[key] = entry
            while len(per) > self.max_entries_per_job:
                oldest = min(per, key=lambda k: per[k]["version"])
                per.pop(oldest)
        return self._n_points(curve)

    def mark_diverged(self, job_id: str, subtask_id: str) -> None:
        with self._lock:
            per = self._jobs.get(job_id)
            if not per:
                return
            for key, entry in per.items():
                if key[0] == str(subtask_id):
                    self._version += 1
                    entry["diverged"] = True
                    entry["version"] = self._version

    @staticmethod
    def _n_points(curve: Dict[str, Any]) -> int:
        n = 0
        for channel in ("loss", "gmax", "score"):
            for row in _rows(curve, channel):
                n += len(row)
        return max(1, n)

    def job(self, job_id: str) -> Optional[Dict[str, Any]]:
        """Full job view for ``GET /curves/<jid>``; None if unknown."""
        with self._lock:
            per = self._jobs.get(job_id)
            if per is None:
                return None
            entries = sorted(per.values(), key=lambda e: e["version"])
            return {
                "job_id": job_id,
                "n_curves": len(entries),
                "curves": [dict(e) for e in entries],
            }

    def subtask(self, job_id: str, subtask_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            per = self._jobs.get(job_id)
            if per is None:
                return None
            entries = [dict(e) for k, e in sorted(per.items(), key=lambda kv: kv[1]["version"]) if k[0] == str(subtask_id)]
        if not entries:
            return None
        return {"job_id": job_id, "subtask_id": str(subtask_id), "curves": entries}

    def updates(self, job_id: str, since: int) -> Tuple[List[Dict[str, Any]], int]:
        """Entries newer than ``since`` plus the new high-water mark —
        the incremental feed behind ``curve`` SSE events."""
        with self._lock:
            per = self._jobs.get(job_id) or {}
            fresh = sorted(
                (dict(e) for e in per.values() if e["version"] > int(since)),
                key=lambda e: e["version"],
            )
            mark = max((e["version"] for e in fresh), default=int(since))
        return fresh, mark

    def n_entries(self, job_id: Optional[str] = None) -> int:
        with self._lock:
            if job_id is not None:
                return len(self._jobs.get(job_id) or {})
            return sum(len(p) for p in self._jobs.values())

    def drop_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)
            try:
                self._order.remove(job_id)
            except ValueError:
                pass
