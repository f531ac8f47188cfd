"""Trial telemetry plane: in-fit learning curves (the ported subset).

The solvers write one ``max|G|`` sample every ``trace_stride(steps)``
iterations into a fixed-size trace buffer (``curve_points()`` slots,
default 64); :func:`build_curve_record` trims it to the populated prefix
and emits the JSON-safe per-trial record that rides the result.

Valves, as in the JAX package's ``obs/curves.py``:

``CS230_CURVES``
    ``auto`` (default, capture on) | ``0`` (no trace buffers, no curve
    leaves in the results).
``CS230_CURVE_POINTS``
    Trace buffer length (default 64, clamped to [4, 512]).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence

_POINTS_MIN = 4
_POINTS_MAX = 512


def curves_enabled() -> bool:
    v = os.environ.get("CS230_CURVES", "auto").strip().lower()
    return v not in ("0", "off", "false")


def curve_points() -> int:
    """Trace buffer length; ``CS230_CURVE_POINTS`` clamped to [4, 512]."""
    try:
        p = int(os.environ.get("CS230_CURVE_POINTS", "64"))
    except ValueError:
        p = 64
    return max(_POINTS_MIN, min(_POINTS_MAX, p))


def trace_stride(steps: int) -> int:
    """Sampling stride so a ``steps``-iteration solve fills at most
    ``curve_points()`` slots (``slot = t // stride``)."""
    steps = max(1, int(steps))
    return max(1, int(math.ceil(steps / float(curve_points()))))


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
