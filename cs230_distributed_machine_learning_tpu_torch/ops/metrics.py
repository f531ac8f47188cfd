"""Weighted evaluation metrics over {0,1} split masks, and the scorer tables.

Port of the JAX package's ``ops/metrics.py``. Every metric reduces over the
last (row) axis and keeps any leading lane dimensions: the port scores a
``[T, S]`` (or ``[L]``) batch of lanes at once where the reference vmaps one
lane. ``y_true`` may be ``[n]`` and broadcast against ``[..., n]``
predictions; probabilities are ``[..., n, k]``.

All scorers are greater-is-better (sklearn's ``neg_*`` convention), so the
trial engine ranks ``mean_cv_score`` the same way whatever the scorer.

CONTRACT — ``w`` is a binary keep-mask, not a general sample weight. The
averaging metrics happen to generalize to real-valued weights, but the
ranking metrics (``weighted_average_precision``, ``weighted_roc_auc_*``) use
``w`` only to exclude rows from their count tables. The CV engine only ever
passes fold masks.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _f32(w):
    return w.to(torch.float32)


def _safe_div(num, den):
    return num / torch.clamp(den, min=_EPS)


def weighted_accuracy(y_true, y_pred, w):
    """sum(w * [y_true == y_pred]) / sum(w) over the last axis."""
    w = _f32(w)
    correct = (y_true == y_pred).to(torch.float32)
    return _safe_div(torch.sum(correct * w, dim=-1), torch.sum(w, dim=-1))


def weighted_mse(y_true, y_pred, w):
    """sum(w * (y_true - y_pred)^2) / sum(w) over the last axis."""
    w = _f32(w)
    err = (y_true - y_pred) ** 2
    return _safe_div(torch.sum(err * w, dim=-1), torch.sum(w, dim=-1))


def weighted_r2(y_true, y_pred, w):
    """1 - SS_res / SS_tot with the mean and both sums weighted by ``w``,
    over the last axis."""
    w = _f32(w)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    ybar = torch.sum(y_true * w, dim=-1, keepdim=True) / wsum
    ss_res = torch.sum(w * (y_true - y_pred) ** 2, dim=-1)
    ss_tot = torch.clamp(torch.sum(w * (y_true - ybar) ** 2, dim=-1), min=_EPS)
    return 1.0 - ss_res / ss_tot


def weighted_mae(y_true, y_pred, w):
    w = _f32(w)
    return _safe_div(torch.sum(torch.abs(y_true - y_pred) * w, dim=-1), torch.sum(w, dim=-1))


def weighted_explained_variance(y_true, y_pred, w):
    """sklearn's explained_variance_score: 1 - Var(y - p) / Var(y), both
    variances weighted over the kept rows."""
    w = _f32(w)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    err = y_true - y_pred
    err_mean = torch.sum(err * w, dim=-1, keepdim=True) / wsum
    var_err = torch.sum(w * (err - err_mean) ** 2, dim=-1) / wsum[..., 0]
    ybar = torch.sum(y_true * w, dim=-1, keepdim=True) / wsum
    var_y = torch.clamp(torch.sum(w * (y_true - ybar) ** 2, dim=-1) / wsum[..., 0], min=_EPS)
    return 1.0 - var_err / var_y


def weighted_max_error(y_true, y_pred, w):
    err = torch.abs(y_true - y_pred)
    return torch.amax(torch.where(w > 0, err, torch.zeros_like(err)), dim=-1)


def _class_counts(y_true, y_pred, w, n_classes):
    """Weighted per-class (tp, pred_count, true_count) ``[..., k]`` over
    the kept rows. With {0,1} masks every count is an exact integer in
    f32, so the scatter's order of additions cannot change it."""
    y_true, y_pred, w = torch.broadcast_tensors(y_true.long(), y_pred.long(), _f32(w))
    zeros = w.new_zeros(w.shape[:-1] + (n_classes,))
    hit = w * (y_true == y_pred).to(torch.float32)
    tp = zeros.scatter_add(-1, y_true, hit)
    pred_c = zeros.scatter_add(-1, y_pred, w)
    true_c = zeros.scatter_add(-1, y_true, w)
    return tp, pred_c, true_c


def _prf(y_true, y_pred, w, n_classes, stat, average):
    """sklearn precision/recall/f1 with average in macro|micro|weighted|
    binary. An undefined per-class stat is 0 (sklearn's zero_division);
    macro averages over the labels in y_true and y_pred, weighted by true
    support."""
    tp, pred_c, true_c = _class_counts(y_true, y_pred, w, n_classes)
    if average == "micro":
        TP, PC, TC = (torch.sum(t, dim=-1) for t in (tp, pred_c, true_c))
        if stat == "precision":
            return _safe_div(TP, PC)
        if stat == "recall":
            return _safe_div(TP, TC)
        return _safe_div(2 * TP, PC + TC)
    prec = _safe_div(tp, pred_c)
    rec = _safe_div(tp, true_c)
    per_class = {
        "precision": prec,
        "recall": rec,
        "f1": _safe_div(2 * prec * rec, prec + rec),
    }[stat]
    if average == "binary":  # pos_label=1, sklearn's default for 2 classes
        return per_class[..., 1]
    if average == "weighted":
        return _safe_div(torch.sum(per_class * true_c, dim=-1), torch.sum(true_c, dim=-1))
    present = ((true_c + pred_c) > 0).to(torch.float32)
    return _safe_div(torch.sum(per_class * present, dim=-1), torch.sum(present, dim=-1))


def weighted_balanced_accuracy(y_true, y_pred, w, n_classes):
    """Mean recall over the classes with true support."""
    tp, _, true_c = _class_counts(y_true, y_pred, w, n_classes)
    present = (true_c > 0).to(torch.float32)
    rec = _safe_div(tp, true_c)
    return _safe_div(torch.sum(rec * present, dim=-1), torch.sum(present, dim=-1))


def weighted_log_loss(y_true, proba, w, n_classes):
    """log_loss over the kept rows: -mean log p(true class), probabilities
    clipped to [f32 eps, 1 - eps] and not renormalised (sklearn >= 1.5's
    order). The reference sums one-hot times log p over the classes; every
    other class adds an exact zero, so taking the true class's column is
    the same number."""
    w = _f32(w)
    eps = torch.finfo(torch.float32).eps
    idx = y_true.long().expand(proba.shape[:-1])[..., None]
    p = torch.clamp(torch.gather(proba, -1, idx)[..., 0], eps, 1.0 - eps)
    return _safe_div(torch.sum(-torch.log(p) * w, dim=-1), torch.sum(w, dim=-1))


def _searchsorted(sorted_seq, values, side):
    """searchsorted over matching leading dims (torch needs them equal)."""
    values = values.expand(sorted_seq.shape[:-1] + values.shape[-1:]).contiguous()
    return torch.searchsorted(sorted_seq.contiguous(), values, side=side)


def weighted_average_precision(y_true, score, w):
    """Binary average precision from a continuous score, tie-exact: the sum
    over positive rows of the precision at their threshold (counting the
    whole tie group), over the positives. Masked rows are pushed to -inf in
    the count tables so searchsorted never counts them."""
    y_true, score, w = torch.broadcast_tensors(y_true, score, w)
    keep = w > 0
    ninf = torch.full_like(score, float("-inf"))
    s_all = torch.sort(torch.where(keep, score, ninf), dim=-1).values
    s_pos = torch.sort(torch.where(keep & (y_true == 1), score, ninf), dim=-1).values
    n_total = score.shape[-1]
    n_ge = (n_total - _searchsorted(s_all, score, "left")).to(torch.float32)
    tp_ge = (n_total - _searchsorted(s_pos, score, "left")).to(torch.float32)
    prec = tp_ge / torch.clamp(n_ge, min=1.0)
    pos_w = (keep & (y_true == 1)).to(torch.float32)
    return _safe_div(torch.sum(prec * pos_w, dim=-1), torch.sum(pos_w, dim=-1))


def weighted_roc_auc_binary(y_true, margin, w):
    """Binary ROC-AUC from a continuous score by the average-rank formula
    (ties count half), as sklearn's trapezoidal roc_auc_score. Masked rows
    are pushed to +inf in the negative-score table."""
    y_true, margin, w = torch.broadcast_tensors(y_true, margin, w)
    keep = w > 0
    neg = keep & (y_true == 0)
    sorted_neg = torch.sort(torch.where(neg, margin, torch.full_like(margin, float("inf"))),
                            dim=-1).values
    n_less = _searchsorted(sorted_neg, margin, "left")
    n_leq = _searchsorted(sorted_neg, margin, "right")
    pair_wins = n_less.to(torch.float32) + 0.5 * (n_leq - n_less).to(torch.float32)
    pos_w = (keep & (y_true == 1)).to(torch.float32)
    P = torch.sum(pos_w, dim=-1)
    N = torch.sum(neg.to(torch.float32), dim=-1)
    return _safe_div(torch.sum(pair_wins * pos_w, dim=-1), P * N)


def _class_support(y_true, w, n_classes):
    w = _f32(w)
    return torch.stack([torch.sum((y_true == c).to(torch.float32) * w, dim=-1)
                        for c in range(n_classes)], dim=-1)


def weighted_roc_auc_ovr(y_true, proba, w, n_classes):
    """One-vs-rest ROC-AUC, macro over the classes with positive support
    (sklearn's multi_class='ovr'); each class scored by its column."""
    aucs = torch.stack([
        weighted_roc_auc_binary((y_true == c).to(torch.int32), proba[..., c], w)
        for c in range(n_classes)], dim=-1)
    present = (_class_support(y_true, w, n_classes) > 0).to(torch.float32)
    return _safe_div(torch.sum(aucs * present, dim=-1), torch.sum(present, dim=-1))


def weighted_roc_auc_ovo(y_true, proba, w, n_classes):
    """One-vs-one ROC-AUC (sklearn's multi_class='ovo', macro): the mean over
    class pairs (a, b) of the two one-sided AUCs on the pair's rows; pairs
    where a class has no kept support are left out of the mean."""
    support = _class_support(y_true, w, n_classes)
    vals, ok = [], []
    for a in range(n_classes):
        for b in range(a + 1, n_classes):
            in_pair = ((y_true == a) | (y_true == b)).to(w.dtype) * w
            auc_a = weighted_roc_auc_binary((y_true == a).to(torch.int32), proba[..., a], in_pair)
            auc_b = weighted_roc_auc_binary((y_true == b).to(torch.int32), proba[..., b], in_pair)
            vals.append(0.5 * (auc_a + auc_b))
            ok.append(((support[..., a] > 0) & (support[..., b] > 0)).to(torch.float32))
    vals, ok = torch.stack(vals, dim=-1), torch.stack(ok, dim=-1)
    return _safe_div(torch.sum(vals * ok, dim=-1), torch.sum(ok, dim=-1))


# ---------------------------------------------------------------------------
# Scorer tables: sklearn scorer name -> weighted metric, all greater-is-better
# ---------------------------------------------------------------------------

_CLS_LABEL_SCORERS = {
    "accuracy": lambda y, p, w, k: weighted_accuracy(y, p, w),
    "balanced_accuracy": weighted_balanced_accuracy,
    "f1": lambda y, p, w, k: _prf(y, p, w, k, "f1", "binary"),
    "f1_macro": lambda y, p, w, k: _prf(y, p, w, k, "f1", "macro"),
    "f1_micro": lambda y, p, w, k: _prf(y, p, w, k, "f1", "micro"),
    "f1_weighted": lambda y, p, w, k: _prf(y, p, w, k, "f1", "weighted"),
    "precision": lambda y, p, w, k: _prf(y, p, w, k, "precision", "binary"),
    "precision_macro": lambda y, p, w, k: _prf(y, p, w, k, "precision", "macro"),
    "precision_micro": lambda y, p, w, k: _prf(y, p, w, k, "precision", "micro"),
    "precision_weighted": lambda y, p, w, k: _prf(y, p, w, k, "precision", "weighted"),
    "recall": lambda y, p, w, k: _prf(y, p, w, k, "recall", "binary"),
    "recall_macro": lambda y, p, w, k: _prf(y, p, w, k, "recall", "macro"),
    "recall_micro": lambda y, p, w, k: _prf(y, p, w, k, "recall", "micro"),
    "recall_weighted": lambda y, p, w, k: _prf(y, p, w, k, "recall", "weighted"),
}

#: scorers evaluated on the binary decision margin [..., n]
_CLS_MARGIN_SCORERS = {
    "roc_auc": weighted_roc_auc_binary,
    "average_precision": weighted_average_precision,
}

#: scorers evaluated on the class-probability matrix [..., n, k]
_CLS_PROBA_SCORERS = {
    "neg_log_loss": lambda y, p, w, k: -weighted_log_loss(y, p, w, k),
    "roc_auc_ovr": weighted_roc_auc_ovr,
    "roc_auc_ovo": weighted_roc_auc_ovo,
}

_REG_SCORERS = {
    "r2": weighted_r2,
    "neg_mean_squared_error": lambda y, p, w: -weighted_mse(y, p, w),
    "neg_root_mean_squared_error": lambda y, p, w: -torch.sqrt(weighted_mse(y, p, w)),
    "neg_mean_absolute_error": lambda y, p, w: -weighted_mae(y, p, w),
    "max_error": lambda y, p, w: -weighted_max_error(y, p, w),
    "explained_variance": weighted_explained_variance,
}

_BINARY_ONLY_SCORERS = frozenset({"f1", "precision", "recall", "roc_auc", "average_precision"})


def scorer_names(task: str) -> frozenset:
    """Every scorer name the engine honours for ``task``."""
    if task == "classification":
        return frozenset(_CLS_LABEL_SCORERS) | frozenset(_CLS_MARGIN_SCORERS) | frozenset(
            _CLS_PROBA_SCORERS)
    if task == "regression":
        return frozenset(_REG_SCORERS)
    return frozenset()


def validate_scoring(scoring, task: str, n_classes: int = 0, kernel=None) -> None:
    """Raise ValueError for a scoring the engine cannot honour, at the engine
    boundary rather than inside a fit: an unknown name, a binary-only
    scorer on a multiclass target (sklearn raises there too), and, given
    the kernel, a margin or probability scorer the kernel has no output
    for. Callable scorers need the winner artifact and an sklearn export,
    which the port does not have yet."""
    if scoring is None:
        return
    if callable(scoring) and not isinstance(scoring, str):
        raise ValueError("callable scoring is not yet ported to the PyTorch package "
                         "(pass a scorer name)")
    if not isinstance(scoring, str):
        raise ValueError(f"scoring must be a sklearn scorer name (got {type(scoring).__name__})")
    known = scorer_names(task)
    if not known:
        raise ValueError(f"scoring={scoring!r} is not applicable to task {task!r}")
    if scoring not in known:
        raise ValueError(f"unsupported scoring {scoring!r} for {task} (supported: {sorted(known)})")
    if scoring in _BINARY_ONLY_SCORERS and n_classes > 2:
        raise ValueError(
            f"scoring={scoring!r} is binary-only but the target has {n_classes} classes "
            f"(sklearn raises here too; use the _macro/_micro/_weighted average variants)"
        )
    if kernel is None:
        return
    from ..models.base import ModelKernel

    if scoring in _CLS_MARGIN_SCORERS and \
            type(kernel).predict_margin is ModelKernel.predict_margin:
        raise ValueError(f"scoring={scoring!r} needs a decision margin, which the "
                         f"{kernel.name} kernel does not expose")
    if scoring in _CLS_PROBA_SCORERS and type(kernel).predict_proba is ModelKernel.predict_proba:
        raise ValueError(f"scoring={scoring!r} needs class probabilities, which the "
                         f"{kernel.name} kernel does not expose")


def scoring_needs_margin(scoring) -> bool:
    return isinstance(scoring, str) and scoring in _CLS_MARGIN_SCORERS


def scoring_needs_proba(scoring) -> bool:
    return isinstance(scoring, str) and scoring in _CLS_PROBA_SCORERS


def proba_score(scoring, y_true, proba, w, n_classes):
    return _CLS_PROBA_SCORERS[scoring](y_true, proba, w, max(int(n_classes), 2))


def classification_score(scoring, y_true, y_pred, w, n_classes):
    """Label-based classification score for the scorer (default accuracy)."""
    if scoring in (None, "accuracy"):
        return weighted_accuracy(y_true, y_pred, w)
    if scoring in _CLS_MARGIN_SCORERS:
        raise ValueError(f"scoring={scoring!r} needs a decision margin; this kernel's "
                         "evaluation path only produces labels")
    return _CLS_LABEL_SCORERS[scoring](y_true, y_pred, w, max(int(n_classes), 2))


def margin_score(scoring, y_true, margin, w):
    return _CLS_MARGIN_SCORERS[scoring](y_true, margin, w)


def regression_score(scoring, y_true, y_pred, w):
    if scoring in (None, "r2"):
        return weighted_r2(y_true, y_pred, w)
    return _REG_SCORERS[scoring](y_true, y_pred, w)
