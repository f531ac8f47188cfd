"""Weighted evaluation metrics over {0,1} split masks.

The part of the JAX package's ``ops/metrics.py`` the ported path needs:
the default classification score (weighted accuracy) and the scorer-name
check. Other scorers are not ported yet and are rejected by name.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def weighted_accuracy(y_true, y_pred, w):
    """sum(w * [y_true == y_pred]) / sum(w) over the last axis."""
    w = w.to(torch.float32)
    correct = (y_true == y_pred).to(torch.float32)
    return torch.sum(correct * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=_EPS)


def validate_scoring(scoring, task: str) -> None:
    """Raise ValueError for a scoring the port cannot honor yet, at the
    engine boundary rather than deep inside a fit."""
    if scoring is None:
        return
    default = "accuracy" if task == "classification" else "r2"
    if scoring != default:
        raise ValueError(
            f"scoring={scoring!r} is not yet ported to the PyTorch package "
            f"(supported: the default {default!r})"
        )
