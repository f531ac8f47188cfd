"""The compressed staging forms of a raw design matrix (``CS230_STAGE_DTYPE``).

Port of the JAX package's ``parallel/trial_map.py`` ``_stage_compress`` /
``_stage_decode`` (its ``:241-346``). Compression runs on the host before
the upload, so that fewer bytes cross the link; the decode is the first
operation on the device and gives back the f32 matrix every kernel
expects. The forms:

- ``"bf16"``: ``{"bf16": X}``, a CPU bf16 tensor rounded to nearest even
  (as ``ml_dtypes`` rounds), half the f32 bytes;
- ``"int8"``: ``{"q8": codes, "scale": per-column max|x| / 127}``, a
  quarter of the f32 bytes plus one float a column;
- ``"f32"``: the matrix itself.

The trial engine (parallel/trial_map.py) stages a whole matrix in one of
these forms, the streamer (data/streaming.py) a row block, and the
drivers and the packed path's staged extras (models/logistic.py) widen
them with :func:`stage_decode`.
"""

from __future__ import annotations

import numpy as np


def stage_compress(X_np: np.ndarray, mode: str):
    """Host-side compression of ``X_np`` under ``mode`` (bf16, int8 or
    f32): the dict forms above, or the f32 matrix."""
    import torch

    X_np = np.asarray(X_np, np.float32)
    if mode == "bf16":
        return {"bf16": torch.from_numpy(np.ascontiguousarray(X_np)).to(torch.bfloat16)}
    if mode == "int8":
        scale = np.maximum(np.abs(X_np).max(axis=0), 1e-30) / 127.0
        q = np.clip(np.rint(X_np / scale), -127, 127).astype(np.int8)
        return {"q8": q, "scale": scale.astype(np.float32)}
    return X_np


def stage_decode(X):
    """Inverse of :func:`stage_compress` on the device: widen bf16 or
    dequantize int8 back to f32; any other value is returned as it is."""
    if isinstance(X, dict) and "bf16" in X:
        return X["bf16"].float()
    if isinstance(X, dict) and "q8" in X:
        return X["q8"].float() * X["scale"][None, :]
    return X


def to_device(form, device):
    """A staged form (an array, a tensor or a dict of them) on ``device``."""
    import torch

    if isinstance(form, dict):
        return {k: to_device(v, device) for k, v in form.items()}
    return torch.as_tensor(form, device=device)
