"""Tree-ensemble kernels: RandomForest and GradientBoosting (classifier and
regressor).

Port of the JAX package's ``models/trees.py``, on the histogram tree
builders of ops/trees.py. The semantics are the reference's:

- structural hyperparameters (n_estimators, max_depth, max_features,
  n_bins) are static, so every combination is its own bucket;
- ``max_depth=None`` (grow to purity) takes the deep arena builder above
  ``CS230_TREE_DEEP_N`` rows, the complete builder to ~log2(n) levels
  below; the arena's width, bins and schedules come from the same bands;
- the bootstrap is the exact multinomial resample through the same
  threefry draws as the reference, and every tree's key is
  ``fold_in(PRNGKey(random_state), t)``, so trees can be fitted one at a
  time, in any grouping, and still be the reference's trees;
- forest prediction averages the trees' leaf values and takes the
  first-index argmax (sklearn's soft vote) or, for a regressor, the mean;
- classification forests histogram integer stats (one-hot counts, B4's
  int32 mode); the regressors' ``y * w`` and boosting's gradients and
  hessians are float stats (B4's f32 mode), summed in other orders on the
  card than on the host;
- boosting is Newton boosting on log-loss or squared-loss gradients
  (leaf value = sum g / sum h) with sklearn's (c-1)/c multinomial leaf
  scale; ``learning_rate`` and ``subsample`` are traced hypers.

Every function works on an explicit lane axis L = trials x splits (the
JAX package vmaps instead): weights ``[L, n]``, stats ``[L, n, k]``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops.trees import (
    COARSE_BINS,
    _gather_leaf,
    bin_data,
    build_tree,
    build_tree_deep,
    predict_tree,
    predict_tree_deep,
    quantile_bins,
)
from ..utils import prng
from ..utils.logging import get_logger
from .base import ModelKernel, score_lanes, to_device, to_host

# Complete-tree caps and the deep arena's bands: the reference's values and
# env knobs (``models/trees.py:59-106`` there, where the sweeps behind them
# are recorded).
_DEPTH_CAP = 10
_DEPTH_HARD_CAP = 14
_DEEP_LEVELS = int(os.environ.get("CS230_DEEP_LEVELS", "24"))
#: levels past log2(n) the arena may grow
_DEEP_LEVEL_MARGIN = int(os.environ.get("CS230_DEEP_LEVEL_MARGIN", "8"))
_DEEP_LEVELS_EXPLICIT = 32
_DEEP_W = int(os.environ.get("CS230_DEEP_W", "1536"))
_DEEP_BINS_CAP = int(os.environ.get("CS230_DEEP_BINS", "48"))
_DEEP_BINS_WIDE = int(os.environ.get("CS230_DEEP_BINS_WIDE", "24"))
_DEEP_BINS_WIDEST = int(os.environ.get("CS230_DEEP_BINS_WIDEST", "16"))
#: adaptive bin resolution: fine bins while the candidate frontier has
#: fewer than this many nodes, _DEEP_BINS_DEEP beyond (0 disables)
_DEEP_BINS_OCC = int(os.environ.get("CS230_DEEP_BINS_OCC", "256"))
_DEEP_BINS_DEEP = int(os.environ.get("CS230_DEEP_BINS_DEEP", "24"))

_warned: set = set()


def _warn_once(key, msg: str, *args) -> None:
    if key in _warned:
        return
    _warned.add(key)
    get_logger().warning(msg, *args)


def _deep_n_threshold() -> int:
    """Rows above which grow-to-purity kernels use the deep builder."""
    return int(os.environ.get("CS230_TREE_DEEP_N", "1024"))


def _resolve_max_features(spec, d: int, default) -> int:
    if spec is None:
        spec = default
    if spec in ("sqrt", "auto"):
        return max(1, int(np.sqrt(d)))
    if spec == "log2":
        return max(1, int(np.log2(max(d, 2))))
    if isinstance(spec, float) and 0 < spec <= 1:
        return max(1, int(spec * d))
    if spec in (1.0, "all"):
        return d
    return max(1, min(int(spec), d))


def _stat_cols(static) -> int:
    """Histogram stat columns (classes + count) of a classification fit."""
    return max(int(static.get("_n_classes", 2)), 2) + 1


class _TreeBase(ModelKernel):
    #: default for max_features resolution (overridden per family)
    _mf_default: Any = 1.0
    #: sklearn grows this family to purity: eligible for the deep arena
    _supports_deep = False
    # random_state seeds the forest's draws: keep it
    ignored_params = ModelKernel.ignored_params - {"random_state"}

    def trace_salt(self):
        """The resolved CS230_STREAM mode (the streamed and single-shot
        drivers stage different forms) and CS230_HIST_KERNEL mode."""
        from ..data.streaming import stream_mode
        from ..ops.trees import _hist_kernel_mode

        return (stream_mode(), _hist_kernel_mode())

    def resolve_static(self, static: Dict[str, Any], n: int, d: int, n_classes: int):
        """The reference's resolution (``models/trees.py:209``): depth or
        arena levels, width bands, bins and their adaptive schedule, the
        resolved max_features, min_samples_leaf and seed."""
        n_bins = int(static.get("n_bins", 128))
        n_bins = min(n_bins, max(8, n))
        depth = static.get("max_depth")
        complete_cap = _DEPTH_HARD_CAP if hasattr(self, "chunked_plan") else _DEPTH_CAP
        deep = (self._supports_deep and n > _deep_n_threshold()
                and (depth is None or int(depth) > complete_cap))
        force_w = None
        if deep:
            grow_to_purity = depth is None
            if grow_to_purity:
                levels = min(_DEEP_LEVELS,
                             int(np.ceil(np.log2(max(n, 8)))) + _DEEP_LEVEL_MARGIN)
            else:
                levels = min(int(depth), _DEEP_LEVELS_EXPLICIT)
            bins_cap = _DEEP_BINS_CAP
            force_w = os.environ.get("CS230_DEEP_W_FORCE")
            if force_w:
                try:
                    width = int(force_w)
                    if width < 64:
                        raise ValueError(force_w)
                except ValueError:
                    raise ValueError(
                        f"CS230_DEEP_W_FORCE={force_w!r}: expected an "
                        "integer arena width >= 64") from None
                _warn_once(("w_force", width),
                           "CS230_DEEP_W_FORCE=%d overrides the deep-arena width "
                           "bands for EVERY grow-to-purity fit in this process", width)
            else:
                if n <= 5000:
                    width = 64
                elif n <= 24576:
                    width = 128
                elif n <= 49152:
                    width = 256
                elif n <= 80_000:
                    width = 1024
                else:
                    width = 1536
                width = min(_DEEP_W, width)
                if width >= 1024:
                    bins_cap = min(bins_cap, _DEEP_BINS_WIDEST if width >= 1536
                                   else _DEEP_BINS_WIDE)
            depth = levels
            fine_cap = max(_DEEP_BINS_CAP, bins_cap)
            eff_fine = min(n_bins, fine_cap)
            deep_nb = min(eff_fine, min(bins_cap, _DEEP_BINS_DEEP))
            nb_occ = _DEEP_BINS_OCC
            if os.environ.get("CS230_DEEP_BINS_OCC") is None and width == 256:
                nb_occ = 384
            sched_ok = nb_occ > 0 and deep_nb < eff_fine and eff_fine % deep_nb == 0
            cap_used = fine_cap if sched_ok else bins_cap
            if "n_bins" in static and n_bins > cap_used:
                _warn_once(("bins", n_bins, cap_used),
                           "deep-tree arena clamps requested n_bins=%d to %d "
                           "(CS230_DEEP_BINS / CS230_DEEP_BINS_WIDE; large-n "
                           "grow-to-purity path only)", n_bins, cap_used)
            n_bins = min(n_bins, cap_used)
            nb_sched = (nb_occ, deep_nb) if sched_ok else None
        elif depth is None:
            depth = min(_DEPTH_CAP, max(3, int(np.ceil(np.log2(max(n, 8)))) - 2))
        else:
            depth = min(int(depth), complete_cap)
        mf = _resolve_max_features(static.get("max_features"), d, self._mf_default)
        msl = static.get("min_samples_leaf", 1)
        if isinstance(msl, float) and msl < 1:
            msl = max(1, int(msl * n))
        out = {
            **static,
            "_depth": depth,
            "_n_bins": n_bins,
            "_mf": mf,
            "_msl": float(msl),
            "_seed": int(static.get("random_state") or 0),
        }
        if deep:
            out["_deep"] = True
            out["_levels"] = levels
            out["_W"] = width
            if nb_sched is not None:
                out["_nb_sched"] = nb_sched
            if width >= 1536 and n > 80_000 and grow_to_purity and not force_w:
                out["_wsched"] = (width, 17, 512)
            elif width >= 1024 and n > 80_000 and grow_to_purity and not force_w:
                out["_wsched"] = (width, 16, width // 2)
        return out

    def memory_estimate_mb(self, n: int, d: int, static: Dict[str, Any]) -> float:
        """Per-lane working set: ~4 histogram-sized buffers of the arena's
        W nodes (deep) or ~3 of the deepest complete level, plus the codes.
        Trees are fitted one at a time, so no tree-group factor."""
        n_bins = int(static.get("_n_bins", 128))
        kk = _stat_cols(static)
        if static.get("_deep"):
            hist = 4.0 * int(static["_W"]) * d * n_bins * kk * 4
        else:
            depth = int(static.get("_depth", 8))
            hist = 3.0 * (2 ** max(depth - 1, 0)) * d * n_bins * kk * 4
        return max(1.0, (hist + 4.0 * n * d * 2) / 1e6)

    @staticmethod
    def _hist_cols(static, d, prepared=None):
        """Bin-column total of a level histogram: d * n_bins, or the
        grouped d_cont * n_bins + d_coarse * COARSE_BINS; the adaptive
        schedule prices at its deep resolution."""
        n_bins = int(static.get("_n_bins", 128))
        sched = static.get("_nb_sched")
        if sched:
            n_bins = int(sched[1])
        if isinstance(prepared, dict) and "xb_coarse" in prepared:
            d_b = prepared["xb_coarse"].shape[1]
            return (d - d_b) * n_bins + d_b * COARSE_BINS
        return d * n_bins

    def macs_estimate(self, n, d, static, prepared=None):
        """Histogram-contraction MACs of one (trial, split) fit in the
        reference's one-hot form: what ``chunked_plan`` divides into
        chunks, so the port chunks a forest exactly as the reference."""
        kk = _stat_cols(static) if self.task == "classification" else 2
        cols = self._hist_cols(static, d, prepared)
        trees = int(static.get("n_estimators", 1))
        if static.get("_deep"):
            W = int(static["_W"])
            levels = int(static["_levels"])
            ramp = int(np.log2(W))
            sched = static.get("_wsched")
            if sched:
                hi, split, lo = (int(x) for x in sched)
                w_sum = (max(min(split, levels) - ramp + 2, 2) * hi
                         + max(levels - split, 0) * lo)
            else:
                w_sum = max(levels - ramp + 2, 2) * W
            per_tree = float(n) * kk * cols * w_sum
        else:
            depth = int(static.get("_depth", 8))
            per_tree = float(n) * (2 ** max(depth - 1, 0)) * kk * cols
        return trees * per_tree

    def _fit_one_tree(self, X, S, C, static, key):
        """One tree per lane through the complete or the deep builder."""
        xb = X["xb"]
        common = dict(
            n_bins=static["_n_bins"],
            min_samples_leaf=static["_msl"],
            max_features=static["_mf"] if static["_mf"] < xb.shape[1] else None,
            key=key,
            # classification stats are one_hot(y) * w, summing to the count
            count_from_stats=self.task == "classification",
        )
        if static.get("_deep"):
            groups = None
            if "xb_coarse" in X:
                groups = {g: X[g] for g in ("xb_cont", "xb_coarse", "fid_cont", "fid_coarse")}
            return build_tree_deep(xb, S, C, levels=static["_levels"], width=static["_W"],
                                   groups=groups, w_schedule=static.get("_wsched"),
                                   nb_schedule=static.get("_nb_sched"), **common)
        return build_tree(xb, S, C, depth=static["_depth"], **common)

    def _tree_predict(self, xq, tree, static):
        if static.get("_deep"):
            return predict_tree_deep(xq, tree, static["_levels"], static["_n_bins"])
        return predict_tree(xq, tree, static["_depth"], static["_n_bins"])

    def prepare_data(self, X: np.ndarray, static: Dict[str, Any]):
        """Bin once per bucket (host numpy): codes, edges and, for the deep
        arena, the low-cardinality feature group (<= COARSE_BINS codes)."""
        edges = quantile_bins(np.asarray(X), static["_n_bins"])
        xb = bin_data(X, edges).numpy()
        out = {"xb": xb, "edges": edges}
        if static.get("_deep"):
            n_codes = 1 + np.isfinite(edges).sum(axis=1)
            coarse = n_codes <= COARSE_BINS
            if coarse.sum() >= 8 and (~coarse).sum() >= 1:
                fid_cont = np.where(~coarse)[0].astype(np.int32)
                fid_coarse = np.where(coarse)[0].astype(np.int32)
                out.update(
                    xb_cont=np.ascontiguousarray(xb[:, fid_cont]),
                    xb_coarse=np.ascontiguousarray(xb[:, fid_coarse]),
                    fid_cont=fid_cont,
                    fid_coarse=fid_coarse,
                )
        return out

    @staticmethod
    def prepared_key(static: Dict[str, Any]):
        """What ``prepare_data`` reads of the resolved static: the trial
        engine's cache key for the prepared forms."""
        return (int(static["_n_bins"]), bool(static.get("_deep")))

    @staticmethod
    def _query_bins(params, X, static):
        """Bin codes of the query rows: the prepared data's own (the search
        path scores the rows it was fitted on), or a raw feature matrix
        binned by the fitted edges (the artifact path)."""
        if isinstance(X, dict):
            return X["xb"]
        return bin_data(X, params["edges"])

    @staticmethod
    def _with_edges(params, X):
        """``params`` plus the prepared data's bin edges, which the artifact
        carries to bin new rows."""
        if isinstance(X, dict):
            params["edges"] = X["edges"]
        return params

    @staticmethod
    def _edges_artifact(params, out, device=None):
        """Copy ``edges`` into ``out``: to host numpy, or to ``device``."""
        if "edges" in params:
            e = params["edges"]
            out["edges"] = to_host(e) if device is None else to_device(e, device)
        return out


def _stack_trees(trees, rows) -> Dict[str, np.ndarray]:
    """Tree dicts with a lane axis -> one dict of host arrays stacked on a
    leading tree axis, each tree's ``rows`` of its lane axis (an index, or
    a slice: a boosting stage's class trees)."""
    return {k: np.stack([to_host(t[k][rows]) for t in trees]) for k in trees[0]}


def _unstack_trees(trees, device, lane_axis: bool) -> List[Dict[str, torch.Tensor]]:
    """Inverse of ``_stack_trees`` for one lane: a list of tree dicts on
    ``device``, each with a lane axis of 1 (``lane_axis``) or with the
    stored axis (a stage's class trees) as its lane axis."""
    n = len(next(iter(trees.values())))
    out = []
    for i in range(n):
        tree = {k: to_device(v[i], device) for k, v in trees.items()}
        out.append({k: v[None] for k, v in tree.items()} if lane_axis else tree)
    return out


def _chunk_plan(units: int, macs: float):
    """The reference's cut of ``units`` trees or stages into dispatches of
    at most ``CS230_TREE_CHUNK_MACS`` (4e13) MACs: {n_chunks,
    trees_per_chunk}, or None when one dispatch holds them."""
    n_chunks = int(np.ceil(macs / float(os.environ.get("CS230_TREE_CHUNK_MACS", 4e13))))
    if n_chunks <= 1:
        return None
    per_chunk = int(np.ceil(units / n_chunks))
    return {"n_chunks": int(np.ceil(units / per_chunk)), "trees_per_chunk": per_chunk}


def _bootstrap_counts(key, w, n: int):
    """Exact bootstrap per lane: n draws with replacement from the rows
    where w > 0, by inverse-CDF search over the active-row count, capped at
    127 (the integer-stat histogram contract). w [L, n] -> counts [L, n].
    All lanes share ``key``; each lane draws below its own active count."""
    active = (w > 0).long()
    caw = torch.cumsum(active, dim=-1)
    n_active = caw[:, -1:]
    targets = prng.randint(key, (n,), 1, torch.clamp(n_active, min=1) + 1)
    rows = torch.searchsorted(caw, targets.long())  # side="left"
    # rows == n (no active row) is out of range and dropped, as segment_sum drops it
    counts = torch.zeros((w.shape[0], n + 1), dtype=torch.float32, device=w.device)
    counts.scatter_add_(1, rows, torch.ones_like(rows, dtype=torch.float32))
    return torch.clamp(counts[:, :n], max=127.0)


class _RandomForestBase(_TreeBase):
    _supports_deep = True  # sklearn RF grows each tree to purity
    static_defaults = {
        "n_estimators": 100,
        "max_depth": None,
        "min_samples_leaf": 1,
        "min_samples_split": 2,
        "max_features": None,
        "bootstrap": True,
        "random_state": 0,
        "n_bins": 128,
        "criterion": "default",
        "min_weight_fraction_leaf": 0.0,
        "max_leaf_nodes": None,
        "min_impurity_decrease": 0.0,
        "oob_score": False,
        "ccp_alpha": 0.0,
        "max_samples": None,
        "monotonic_cst": None,
    }

    def _one_tree(self, X, S, C, static, key):
        """Bootstrap from the tree key's first half, features from its
        second, then fit the tree on every lane."""
        boot_key, feat_key = prng.split(key).unbind(-2)
        if static.get("bootstrap", True):
            counts = _bootstrap_counts(boot_key, C, S.shape[1])
        else:
            counts = (C > 0).to(torch.float32)
        return self._fit_one_tree(X, S * counts[..., None], C * counts, static, feat_key)

    def _tree_keys(self, static, ids, device):
        base = prng.PRNGKey(static["_seed"], device=device)
        return [prng.fold_in(base, int(t)) for t in ids]

    def _fit_forest(self, X, S, C, static) -> List[Dict[str, torch.Tensor]]:
        """Every tree of the forest, one after another, tree t keyed by
        ``fold_in(base, t)`` (the reference's stream for any grouping)."""
        n_trees = int(static.get("n_estimators", 100))
        keys = self._tree_keys(static, range(n_trees), S.device)
        return [self._one_tree(X, S, C, static, key) for key in keys]

    # ---- chunked-fit protocol (parallel/trial_map.py::_run_chunked) ----
    # The trees of a forest are split across several steps; the state
    # between steps is the running sum of per-tree leaf predictions for
    # every row and lane, and eval finalizes the soft-vote mean.

    def chunked_plan(self, static, n, d, n_classes, n_splits, prepared=None, device=None):
        """Trees per dispatch from the MAC budget (``device`` is not read:
        the forest's plan is the same on every device)."""
        macs = float(max(n_splits, 1)) * self.macs_estimate(n, d, static, prepared)
        return _chunk_plan(int(static.get("n_estimators", 100)), macs)

    def _stat_matrix(self, y, w, static):
        """Per-lane stats ``[L, n, k]``: one-hot classes times the lane
        weights (k = classes), or ``y * w`` for a regressor (k = 1)."""
        if self.task == "classification":
            c = max(int(static["_n_classes"]), 2)
            onehot = torch.nn.functional.one_hot(y.long(), c).to(torch.float32)
            return onehot[None] * w[..., None], c
        return (y.to(torch.float32)[None] * w)[..., None], 1

    def chunk_init(self, X, y, w, hyper, static):
        _, k = self._stat_matrix(y, w, static)
        return torch.zeros((w.shape[0], X["xb"].shape[0], k), dtype=torch.float32,
                           device=w.device)

    def chunk_step(self, X, y, w, hyper, static, chunk_idx, state, plan):
        """Fit the chunk's trees (ids ``chunk_idx * g + i``, those past
        n_estimators skipped) and add their predictions to the state."""
        w = w.to(torch.float32)
        S, _ = self._stat_matrix(y, w, static)
        n_trees = int(static.get("n_estimators", 100))
        g = plan["trees_per_chunk"]
        ids = [t for t in range(chunk_idx * g, (chunk_idx + 1) * g) if t < n_trees]
        for key in self._tree_keys(static, ids, w.device):
            tree = self._one_tree(X, S, w, static, key)
            state = state + self._tree_predict(X["xb"], tree, static)
        return state

    def chunk_eval(self, X, y, w_eval, hyper, static, state):
        n_trees = int(static.get("n_estimators", 100))
        return self._score(static, y, _vote_mean(state, n_trees), w_eval)

    # the winner's refit (parallel/trial_map.py::fit_single): the chunk's
    # trees themselves, assembled into the artifact after the last chunk

    def fit_chunk(self, X, y, w, hyper, static, chunk_idx, carry, plan):
        """The chunk's trees (ids past n_estimators skipped); ``carry``
        passes through."""
        w = w.to(torch.float32)
        S, _ = self._stat_matrix(y, w, static)
        n_trees = int(static.get("n_estimators", 100))
        g = plan["trees_per_chunk"]
        ids = [t for t in range(chunk_idx * g, (chunk_idx + 1) * g) if t < n_trees]
        return carry, [self._one_tree(X, S, w, static, key)
                       for key in self._tree_keys(static, ids, w.device)]

    def assemble_artifact(self, trees, X, hyper, static, data_y, data_w):
        return self._with_edges({"trees": trees}, X)

    def artifact_params(self, params, lane: int = 0):
        """The trees stacked on a leading ``[n_estimators]`` axis, as the
        JAX forest holds them (every tree of a forest has the same arena
        shapes), and the bin edges."""
        return self._edges_artifact(params, {"trees": _stack_trees(params["trees"], lane)})

    def params_from_artifact(self, np_params, device):
        return self._edges_artifact(
            np_params, {"trees": _unstack_trees(np_params["trees"], device, True)}, device)

    def _score(self, static, y, mean, w_eval):
        """The job's score of the mean leaf values ``[L, n, k]``: the soft
        vote's outputs (``_vote_outputs``), or the mean prediction."""
        if self.task == "classification":
            return score_lanes(self, static, y, w_eval, **_vote_outputs(mean))
        return score_lanes(self, static, y, w_eval, predict=lambda: mean[..., 0])

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """Forests of every lane: w [L, n] fit weights."""
        w = w.to(torch.float32)
        S, _ = self._stat_matrix(y, w, static)
        return self.assemble_artifact(self._fit_forest(X, S, w, static), X, hyper, static, y, w)

    # ---- out-of-core row-block streaming (data/streaming.py) ----

    def stream_applicable(self, static: Dict[str, Any], n: int, d: int) -> bool:
        """Complete-tree classification forests only: the deep arena keeps
        per-level routing tables over all rows, and a regressor's float
        stats would let f32 order move the splits themselves."""
        return (not static.get("_deep") and self.task == "classification"
                and int(static.get("_depth", 0)) >= 1)

    def stream_form(self, X_np, static: Dict[str, Any]):
        """Blocks are sliced from the prepared bin codes (the only per-row
        array the builder reads); the edges stay on the host."""
        xb = X_np["xb"] if isinstance(X_np, dict) else np.asarray(X_np)
        return np.ascontiguousarray(xb), ("xb", int(static["_n_bins"]))

    def stream_scores(self, streamer, y_pad, TW, EW, hyper_batch, static, n):
        """Block-accumulated forest fit and soft-vote accuracy over a
        RowBlockStreamer: every (split, tree) is one one-lane
        ``build_tree_streamed`` (depth + 1 passes; on the card one B4
        launch a level block), equal to the bit to ``build_tree`` on these
        integer stats. Tree t's key is ``fold_in(base, t)`` and its
        bootstrap is drawn on the unpadded rows, so the draws are the
        single-shot path's; predictions for the fitted rows are the
        builder's final node ids, looked up. RF hypers are static, so every
        trial of the chunk gets the same ``[S]`` row; returns ``[T, S]``
        numpy."""
        from ..ops.trees import build_tree_streamed

        dev = TW.device
        c = max(int(static["_n_classes"]), 2)
        n_splits, n_pad = TW.shape
        d = int(streamer.row_shape[0])
        depth = int(static["_depth"])
        mf = static["_mf"] if static["_mf"] < d else None
        n_trees = int(static.get("n_estimators", 100))
        n_internal = 2**depth - 1

        def stream_pass(fn, carry, *consts):
            for _i, start, blk in streamer.iter_blocks():
                carry = fn(carry, *consts, blk, start)
            return carry

        y = y_pad[:n]
        onehot = torch.nn.functional.one_hot(y_pad.long(), c).to(torch.float32)
        pad = torch.zeros((n_pad - n,), dtype=torch.float32, device=dev)
        keys = self._tree_keys(static, range(n_trees), dev)
        scores = np.zeros((n_splits,), np.float32)
        for s in range(n_splits):
            w = TW[s:s + 1].to(torch.float32)  # one lane [1, n_pad]
            Sw = onehot[None] * w[..., None]
            total = None
            for key in keys:
                boot_key, feat_key = prng.split(key).unbind(-2)
                if static.get("bootstrap", True):
                    counts = torch.cat([_bootstrap_counts(boot_key, w[:, :n], n)[0], pad])[None]
                else:
                    counts = (w > 0).to(torch.float32)
                tree, node = build_tree_streamed(
                    stream_pass, Sw * counts[..., None], w * counts, d, depth=depth,
                    n_bins=int(static["_n_bins"]), min_samples_leaf=static["_msl"],
                    max_features=mf, key=feat_key, count_from_stats=True)
                vals = _gather_leaf(tree["leaf_val"], node[:, :n] - n_internal)
                total = vals if total is None else total + vals
            out = self._score(static, y, _vote_mean(total, n_trees), EW[s:s + 1, :n])
            scores[s] = float(out["score"][0])
        n_t = len(next(iter(hyper_batch.values()))) if hyper_batch else 1
        return np.broadcast_to(scores, (max(int(n_t), 1), n_splits)).copy()

    def _forest_leaf_mean(self, params, xq, static):
        """Mean of the trees' leaf values, summed tree by tree."""
        total = None
        for tree in params["trees"]:
            vals = self._tree_predict(xq, tree, static)
            total = vals if total is None else total + vals
        return _vote_mean(total, len(params["trees"]))

    def _mean(self, params, X, static):
        return self._forest_leaf_mean(params, self._query_bins(params, X, static), static)

    def evaluate(self, params, X, y, w, static: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Scores of every lane on the rows selected by w [L, n]."""
        return self._score(static, y, self._mean(params, X, static), w)

    def batched_scores(self, X, y, TW, EW, hyper, static):
        """``[T, S]`` scores: every (trial, split) pair is one lane (lane =
        trial * S + split) of one ``fit`` and one ``evaluate``. The forest
        has no traced hypers; ``hyper`` carries only the trial count."""
        T, S = next(iter(hyper.values())).shape[0], TW.shape[0]
        fitted = self.fit(X, y, TW.repeat(T, 1), {}, static)
        out = self.evaluate(fitted, X, y, EW.repeat(T, 1), static)
        return {k: v.reshape(T, S) for k, v in out.items()}


def _vote_mean(total, n_trees: int):
    """Soft-vote mean: the f32 sum times f32(1 / n_trees), the reference's
    arithmetic (XLA rewrites the division by a constant to this product)."""
    return total * float(np.float32(1.0) / np.float32(n_trees))


def _vote_outputs(proba):
    """``score_lanes``' outputs of leaf class distributions ``[..., n, c]``
    (a forest's soft vote, a tree's leaf frequencies): the first-index
    argmax as the label, p(1) - p(0) as the binary margin, the
    distribution normalised as the probabilities."""
    return {"predict": lambda: torch.argmax(proba, dim=-1),
            "margin": lambda: proba[..., 1] - proba[..., 0],
            "proba": lambda: _normalised(proba)}


def _normalised(proba):
    """Rows over their sum, the sum taken class by class in order: a
    reduction's order differs between the card and the CPU, and a last-bit
    difference would break or make the exact ties the ranking scorers
    count half."""
    total = proba[..., 0]
    for k in range(1, proba.shape[-1]):
        total = total + proba[..., k]
    return proba / torch.clamp(total, min=1e-12)[..., None]


class RandomForestClassifierKernel(_RandomForestBase):
    name = "RandomForestClassifier"
    task = "classification"
    _mf_default = "sqrt"

    def predict(self, params, X, static):
        """Labels ``[L, n]``: the soft vote's first-index argmax."""
        return torch.argmax(self._mean(params, X, static), dim=-1)

    def predict_margin(self, params, X, static):
        mean = self._mean(params, X, static)
        return mean[..., 1] - mean[..., 0]

    def predict_proba(self, params, X, static):
        """The soft vote's mean leaf class distribution, normalised."""
        return _normalised(self._mean(params, X, static))


class RandomForestRegressorKernel(_RandomForestBase):
    """Regression stats ``y * w`` are not counts: the count column is the
    weights' own and the level histograms take B4's float mode."""

    name = "RandomForestRegressor"
    task = "regression"
    _mf_default = 1.0

    def predict(self, params, X, static):
        """The trees' mean ``[L, n]``."""
        return self._mean(params, X, static)[..., 0]


class _GradientBoostingBase(_TreeBase):
    """Newton boosting on the histogram trees (JAX ``models/trees.py:974``).

    Stages are sequential; the state between stages, and between the
    dispatches of ``_run_chunked``, is every lane's raw score F (``[L, n,
    c]`` classifier, ``[L, n]`` regressor), and the search's scores come
    from F directly. ``fit`` (the winner's refit) keeps the stages' trees,
    and ``predict*`` replay them on new rows (``_raw_scores``). Stage t is
    keyed ``fold_in(PRNGKey(random_state), t)`` and split into a subsample
    key and a feature key, so any grouping of stages gives the reference's
    trees. ``learning_rate`` and
    ``subsample`` are traced: one value per lane. Subclasses give
    ``_prior``, ``_f0``, ``_stage_stats`` and ``_update``."""

    hyper_defaults = {"learning_rate": 0.1, "subsample": 1.0}
    static_defaults = {
        "n_estimators": 100,
        "max_depth": 3,
        "min_samples_leaf": 1,
        "min_samples_split": 2,
        "max_features": None,
        "random_state": 0,
        "n_bins": 128,
        "loss": "default",
        "criterion": "friedman_mse",
        "init": None,
        "alpha": 0.9,
        "validation_fraction": 0.1,
        "n_iter_no_change": None,
        "tol": 1e-4,
        "min_weight_fraction_leaf": 0.0,
        "max_leaf_nodes": None,
        "min_impurity_decrease": 0.0,
        "ccp_alpha": 0.0,
    }
    _mf_default = 1.0

    def chunked_plan(self, static, n, d, n_classes, n_splits, prepared=None, device=None):
        """Stages per dispatch from the MAC budget, with the reference's
        task weights (6 classifier, 10 regressor), so the port cuts a fit
        into the reference's chunks (``device`` and ``prepared`` are not
        read)."""
        weight = 6.0 if self.task == "classification" else 10.0
        macs = weight * float(max(n_splits, 1)) * self.macs_estimate(n, d, static)
        return _chunk_plan(int(static.get("n_estimators", 100)), macs)

    def _k_eff(self, static) -> int:
        """Trees a stage: one a class past two classes, else one."""
        nc = max(int(static.get("_n_classes", 2)), 2)
        return nc if (self.task == "classification" and nc > 2) else 1

    def memory_estimate_mb(self, n: int, d: int, static: Dict[str, Any]) -> float:
        """A stage's k_eff trees are lanes of one builder call: each with
        the complete builder's working set and ~64 bytes a row of stats,
        node ids and leaf values."""
        return self._k_eff(static) * (super().memory_estimate_mb(n, d, static) + 64.0 * n / 1e6)

    def macs_estimate(self, n, d, static, prepared=None):
        """Per-stage (gradient, hessian) histogram trees: k_eff trees of
        two stat columns (the reference's formula; ``prepared`` unused)."""
        stages = int(static.get("n_estimators", 100))
        k_eff = self._k_eff(static)
        depth = int(static.get("_depth", 3))
        n_bins = int(static.get("_n_bins", 128))
        return float(stages) * k_eff * n * (2 ** max(depth - 1, 0)) * 2 * d * n_bins

    def _tree(self, xb, S, C, static, key):
        """One complete tree per lane on float stats (B4's float mode)."""
        return build_tree(
            xb, S, C, depth=static["_depth"], n_bins=static["_n_bins"],
            min_samples_leaf=static["_msl"],
            max_features=static["_mf"] if static["_mf"] < xb.shape[1] else None, key=key)

    @staticmethod
    def _subsample(sub_key, w, subsample):
        """Rows of each lane's stage: the shared uniforms below the lane's
        ``subsample``, times its fit weights."""
        u = prng.uniform(sub_key, (w.shape[1],))
        return (u[None] < subsample.to(torch.float32)[:, None]).to(torch.float32) * w

    def _stage(self, xb, y, w, hyper, static, F, key):
        """One boosting stage of every lane: (F, stage key) -> (F', trees).
        The stage's trees are one ``build_tree`` call whose lanes are the
        subclass's ``_stage_stats``."""
        sub_key, feat_key = prng.split(key).unbind(-2)
        mask = self._subsample(sub_key, w, hyper["subsample"])
        S, C, tree_key = self._stage_stats(y, mask, F, static, feat_key)
        tree = self._tree(xb, S, C, static, tree_key)
        delta = predict_tree(xb, tree, static["_depth"], static["_n_bins"])[..., 0]
        return self._update(F, delta, hyper["learning_rate"].to(torch.float32), static), tree

    def _stages(self, xb, y, w, hyper, static, F, ids, trees=None):
        """F after the stages ``ids``, in order; each stage's trees are
        appended to ``trees`` where a list is given."""
        base = prng.PRNGKey(static["_seed"], device=w.device)
        for t in ids:
            F, tree = self._stage(xb, y, w, hyper, static, F, prng.fold_in(base, int(t)))
            if trees is not None:
                trees.append(tree)
        return F

    # ---- chunked-fit protocol (parallel/trial_map.py::_run_chunked) ----

    def chunk_init(self, X, y, w, hyper, static):
        return self._f0(X["xb"].shape[0], self._prior(y, w.to(torch.float32), static), static)

    def chunk_step(self, X, y, w, hyper, static, chunk_idx, state, plan):
        """Advance F by the chunk's stages (``chunk_idx * g + i``, those
        past n_estimators skipped)."""
        return self.fit_chunk(X, y, w, hyper, static, chunk_idx, state, plan)[0]

    def fit_chunk(self, X, y, w, hyper, static, chunk_idx, carry, plan):
        """(F, the trees) after the chunk's stages (``chunk_idx * g + i``,
        those past n_estimators skipped)."""
        n_stages = int(static.get("n_estimators", 100))
        g = plan["trees_per_chunk"]
        ids = [t for t in range(chunk_idx * g, (chunk_idx + 1) * g) if t < n_stages]
        trees = []
        F = self._stages(X["xb"], y, w.to(torch.float32), hyper, static, carry, ids, trees)
        return F, trees

    def assemble_artifact(self, trees, X, hyper, static, data_y, data_w):
        """Every stage's trees, the prior and the learning rate of each
        lane, and the bin edges: what ``_raw_scores`` replays."""
        return self._with_edges({
            "trees": trees,
            "prior": self._prior(data_y, data_w.to(torch.float32), static),
            "lr": hyper["learning_rate"].to(torch.float32),
        }, X)

    def fit(self, X, y, w, hyper: Dict[str, Any], static: Dict[str, Any]):
        """Every stage of every lane: w [L, n] fit weights, hypers [L]."""
        w = w.to(torch.float32)
        trees = []
        self._stages(X["xb"], y, w, hyper, static, self.chunk_init(X, y, w, hyper, static),
                     range(int(static.get("n_estimators", 100))), trees)
        return self.assemble_artifact(trees, X, hyper, static, y, w)

    def _raw_scores(self, params, X, static):
        """F of the query rows: the lanes' priors, then every stage's trees
        at the rows' bins, through the subclass's ``_update``."""
        xq = self._query_bins(params, X, static)
        F = self._f0(xq.shape[0], params["prior"], static)
        for tree in params["trees"]:
            delta = predict_tree(xq, tree, static["_depth"], static["_n_bins"])[..., 0]
            F = self._update(F, delta, params["lr"], static)
        return F

    def artifact_params(self, params, lane: int = 0):
        """The JAX layout: stage trees on a leading ``[n_estimators]`` axis
        (the classifier's with a class-tree axis after it, of one tree for a
        binary fit), the lane's prior and learning rate, the bin edges."""
        rows = lane
        if self.task == "classification":  # lane l's class trees: l * kdim + k
            kdim = params["trees"][0]["leaf_val"].shape[0] // params["prior"].shape[0]
            rows = slice(lane * kdim, (lane + 1) * kdim)
        return self._edges_artifact(params, {
            "trees": _stack_trees(params["trees"], rows),
            "prior": to_host(params["prior"][lane]),
            "lr": to_host(params["lr"][lane]),
        })

    def params_from_artifact(self, np_params, device):
        return self._edges_artifact(np_params, {
            "trees": _unstack_trees(np_params["trees"], device,
                                    lane_axis=self.task != "classification"),
            "prior": to_device(np_params["prior"], device)[None],
            "lr": to_device(np_params["lr"], device).reshape(1),
        }, device)

    def chunk_eval(self, X, y, w_eval, hyper, static, state):
        """The job's score of the raw scores F (the state) on the rows it
        was fitted on: F's first-index argmax as the label, F[:, 1] -
        F[:, 0] as the binary margin (a binary fit keeps F[:, 0] at zero),
        softmax(F) as the probabilities; a regressor's F is its prediction."""
        F = state
        if self.task == "classification":
            return score_lanes(self, static, y, w_eval,
                               predict=lambda: torch.argmax(F, dim=-1),
                               margin=lambda: F[..., 1] - F[..., 0],
                               proba=lambda: torch.softmax(F, dim=-1))
        return score_lanes(self, static, y, w_eval, predict=lambda: F)

    def batched_scores(self, X, y, TW, EW, hyper, static):
        """``[T, S]`` scores of one unchunked fit: lane = trial * S + split,
        every stage on every lane, then the scores of F."""
        T, S = hyper["learning_rate"].shape[0], TW.shape[0]
        w = TW.repeat(T, 1).to(torch.float32)
        lanes = {k: v.repeat_interleave(S) for k, v in hyper.items()}
        F = self.chunk_init(X, y, w, lanes, static)
        F = self._stages(X["xb"], y, w, lanes, static, F,
                         range(int(static.get("n_estimators", 100))))
        out = self.chunk_eval(X, y, EW.repeat(T, 1), lanes, static, F)
        return {k: v.reshape(T, S) for k, v in out.items()}


class GradientBoostingClassifierKernel(_GradientBoostingBase):
    """Log-loss boosting: the binary fit keeps ``F[:, 0] = 0`` and grows one
    tree a stage on ``F[:, 1]``; a c-class fit grows c trees a stage, each
    with its own feature key (``split(feat_key, c)``), leaves scaled by
    ``(c - 1) / c``. A stage's class trees are extra lanes of one
    ``build_tree`` call (B4 launched once a level for all of them)."""

    name = "GradientBoostingClassifier"
    task = "classification"

    def predict(self, params, X, static):
        """Labels ``[L, n]``: F's first-index argmax."""
        return torch.argmax(self._raw_scores(params, X, static), dim=-1)

    def predict_margin(self, params, X, static):
        """F[:, 1] - F[:, 0] (a binary fit keeps F[:, 0] at zero)."""
        F = self._raw_scores(params, X, static)
        return F[..., 1] - F[..., 0]

    def predict_proba(self, params, X, static):
        """softmax(F) (sklearn's predict_proba of the raw scores)."""
        return torch.softmax(self._raw_scores(params, X, static), dim=-1)

    def _prior(self, y, w, static):
        """Per-lane log class priors ``[L, c]``."""
        c = max(int(static["_n_classes"]), 2)
        Y = torch.nn.functional.one_hot(y.long(), c).to(torch.float32)
        wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
        return torch.log(torch.clamp(torch.sum(Y[None] * w[..., None], dim=1) / wsum,
                                     min=1e-12))

    def _f0(self, n, prior, static):
        if max(int(static["_n_classes"]), 2) > 2:
            return prior[:, None, :].expand(-1, n, -1).contiguous()
        lift = (prior[:, 1] - prior[:, 0])[:, None].expand(-1, n)
        return torch.stack([torch.zeros_like(lift), lift], dim=-1)

    def _stage_stats(self, y, mask, F, static, feat_key):
        """A stage's tree lanes from F [L, n, c] and the subsampled weights
        mask [L, n]: stats ``[L * kdim, n, 1]`` (gradients), count column
        ``[L * kdim, n]`` (hessians, floored at 1e-12) and one key a lane;
        kdim is c, or 1 for a binary fit."""
        c = max(int(static["_n_classes"]), 2)
        L, n = mask.shape
        Y = torch.nn.functional.one_hot(y.long(), c).to(torch.float32)
        mask = mask[..., None]
        if c > 2:
            P = torch.softmax(F, dim=-1)
            G = (Y - P) * mask
            H = P * (1.0 - P) * mask
        else:
            P = torch.sigmoid(F[..., 1:])
            G = (Y[:, 1:] - P) * mask
            H = (P * (1.0 - P)) * mask
        kdim = G.shape[-1]
        # lane l * kdim + k is lane l's class-k tree, keyed as class k's
        keys = prng.split(feat_key, kdim).repeat(L, 1)
        S = G.transpose(1, 2).reshape(L * kdim, n, 1)
        C = torch.clamp(H, min=1e-12).transpose(1, 2).reshape(L * kdim, n)
        return S, C, keys

    def _update(self, F, delta, lr, static):
        """F plus the learning rate times the class trees' leaf values
        (delta [L * kdim, n]), scaled by (c - 1) / c past two classes."""
        c = max(int(static["_n_classes"]), 2)
        L, n = F.shape[:2]
        if c > 2:
            delta = delta.reshape(L, c, n).transpose(1, 2)
            return F + (lr * ((c - 1) / c))[:, None, None] * delta
        return torch.stack([F[..., 0], F[..., 1] + lr[:, None] * delta], dim=-1)


class GradientBoostingRegressorKernel(_GradientBoostingBase):
    """Squared-loss boosting: one tree a stage on the residuals, the
    subsampled weights as its count column."""

    name = "GradientBoostingRegressor"
    task = "regression"

    def _prior(self, y, w, static):
        """Per-lane weighted mean of y ``[L]``."""
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
        return torch.sum(y.to(torch.float32)[None] * w, dim=-1) / wsum

    def _f0(self, n, prior, static):
        return prior[:, None].expand(-1, n).contiguous()

    def _stage_stats(self, y, mask, F, static, feat_key):
        """Residual stats ``[L, n, 1]``, the subsampled weights as the count
        column, the stage's feature key shared by the lanes."""
        return ((y.to(torch.float32)[None] - F) * mask)[..., None], mask, feat_key

    def _update(self, F, delta, lr, static):
        return F + lr[:, None] * delta

    def predict(self, params, X, static):
        """Predictions ``[L, n]``: F."""
        return self._raw_scores(params, X, static)
