"""Weighted evaluation metrics over {0,1} split masks.

The part of the JAX package's ``ops/metrics.py`` the ported paths need:
the default classification score (weighted accuracy), the default
regression score and its extra leaf (weighted r2 and MSE), and the
scorer-name check. Other scorers are not ported yet and are rejected by
name.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def weighted_accuracy(y_true, y_pred, w):
    """sum(w * [y_true == y_pred]) / sum(w) over the last axis."""
    w = w.to(torch.float32)
    correct = (y_true == y_pred).to(torch.float32)
    return torch.sum(correct * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=_EPS)


def weighted_mse(y_true, y_pred, w):
    """sum(w * (y_true - y_pred)^2) / sum(w) over the last axis."""
    w = w.to(torch.float32)
    err = (y_true - y_pred) ** 2
    return torch.sum(err * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=_EPS)


def weighted_r2(y_true, y_pred, w):
    """1 - SS_res / SS_tot with the mean and both sums weighted by ``w``,
    over the last axis."""
    w = w.to(torch.float32)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    ybar = torch.sum(y_true * w, dim=-1, keepdim=True) / wsum
    ss_res = torch.sum(w * (y_true - y_pred) ** 2, dim=-1)
    ss_tot = torch.clamp(torch.sum(w * (y_true - ybar) ** 2, dim=-1), min=_EPS)
    return 1.0 - ss_res / ss_tot


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
