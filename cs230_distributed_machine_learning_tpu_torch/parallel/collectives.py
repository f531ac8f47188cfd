"""Cross-trial aggregation on one device.

Port of the JAX package's ``parallel/collectives.py::best_trial`` for a
single device: the scores are host scalars already once results are
collected, so the argmax runs on the host. The collective (mesh) forms
come with the multi-device slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def best_trial(mean_scores: Sequence[float]) -> Tuple[int, float]:
    """argmax over the per-trial score vector, first index on ties
    (sklearn's ``best_index_`` rule). Returns (index, score)."""
    s = np.asarray(mean_scores, np.float64)
    idx = int(np.argmax(s))
    return idx, float(s[idx])

