"""JSON-safe serialization of numpy / torch / pandas values.

A copy of the JAX package's ``utils/serialization.py``: the client-side
serializer + NaN scrubber of the reference
(``DistributedLibrary/src/distributed_ml/core.py:60-80``), used for job
payloads, the job journal and results.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


def json_safe(obj: Any) -> Any:
    """Recursively convert a value into plain JSON-compatible Python types."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return None if (math.isnan(obj) or math.isinf(obj)) else obj
    if isinstance(obj, (np.floating,)):
        f = float(obj)
        return None if (math.isnan(f) or math.isinf(f)) else f
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return [json_safe(v) for v in obj.tolist()]
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [json_safe(v) for v in obj]
    # tensors and pandas objects without importing them eagerly
    if hasattr(obj, "tolist"):
        return json_safe(obj.tolist())
    if hasattr(obj, "to_dict"):
        return json_safe(obj.to_dict())
    return str(obj)

