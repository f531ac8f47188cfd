"""Histogram decision-tree builders over an explicit lane axis.

Port of the JAX package's ``ops/trees.py``. The JAX builders fit one tree
and are vmapped over (trial, split) lanes; here every builder takes the
lanes as a leading axis L: node ids ``[L, n]``, stats ``[L, n, k]``,
weights ``[L, n]``, while the bin codes ``[n, d]`` are shared. The
algorithms are the reference's, step for step:

- features are binned once per dataset into quantile bins (int codes);
- trees grow level-wise; each level's node x feature x bin histograms come
  from one kernel launch over all lanes (``ops/cuda_hist.py``), right
  children by subtraction from the parent;
- the split score is the unified ``sum_k S_k^2 / C`` proxy;
- ``build_tree`` grows a complete tree of static depth, ``build_tree_deep``
  a frontier-compacted arena (batched best-first) to purity.

The JAX code routes rows and sums leaves with one-hot matrix products
(``_col_select``, ``_route_left``, ``_leaf_sums``, ``_leaf_select``)
because gathers and segment sums serialize on a TPU; those products select
exactly one term, so they equal a gather. On the card gathers and
``scatter_add_`` are the natural form, and the port uses them.

Random feature subsets and the arena's candidate order follow the
reference bit for bit: threefry draws (utils/prng.py), a stable
descending sort for ``lax.top_k`` (lower index first on ties), and first-
index argmax over (feature, bin).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import prng
from . import cuda_hist

_EPS = 1e-12


def quantile_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Host-side per-feature bin edges (n_bins-1 interior cut points) from
    quantiles of the whole dataset; duplicate quantiles are deduped per
    feature and the tail padded with +inf, so low-cardinality columns get
    compact codes ``[0, n_distinct]``."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(X, qs, axis=0).T  # [d, n_bins-1]
    out = np.full(edges.shape, np.inf, np.float32)
    for f in range(edges.shape[0]):
        u = np.unique(edges[f])  # sorted, deduped
        out[f, : len(u)] = u
    return np.ascontiguousarray(out)


def bin_data(X, edges) -> torch.Tensor:
    """Bin codes ``[n, d]`` int32: per column, the number of edges <= x
    (``searchsorted(side="right")`` against the +inf-padded edges)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    E = torch.as_tensor(edges, dtype=torch.float32, device=X.device)
    codes = torch.searchsorted(E.contiguous(), X.T.contiguous(), right=True)
    return codes.T.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# level histograms
# ---------------------------------------------------------------------------


def _hist_kernel_mode() -> str:
    """CS230_HIST_KERNEL valve, the reference's names: ``auto`` (default)
    and ``pallas`` (its alias) launch kernel B4 on CUDA tensors;
    ``scatter`` and ``matmul`` name the reference's plain XLA forms, which
    the card does not run. CPU tensors take the plain version under every
    name."""
    mode = os.environ.get("CS230_HIST_KERNEL", "auto").lower()
    return mode if mode in ("auto", "matmul", "scatter", "pallas") else "auto"


def _level_histogram_multi(local, xbs, SC, n_nodes: int, n_binss,
                           integer_stats: bool = False):
    """Feature-grouped level histograms: a tuple of ``[L, n_nodes, d_g,
    nb_g, kk]``, one per (xb_g, nb_g) group, one launch per group.

    ``CS230_HIST_COMPACT=1`` (with ``CS230_HIST_BLOCK_ROWS`` /
    ``_NODES``) is accepted and changes nothing here: the reference's
    compact histogram (JAX ``ops/trees.py:229-380``) is an XLA form of its
    dense one-hot contraction, equal to it bit for bit on integer stats,
    and the port has no one-hot contraction to compact (ROADMAP C37)."""
    mode = _hist_kernel_mode()
    if local.is_cuda and mode not in ("auto", "pallas"):
        raise ValueError(f"CS230_HIST_KERNEL={mode}: on the card the level "
                         "histogram is kernel B4 only (auto or pallas)")
    local = local.to(torch.int32).contiguous()
    SC = SC.to(torch.float32).contiguous()
    return tuple(
        cuda_hist.level_histogram(local, xb, SC, n_nodes, nb, integer_stats=integer_stats)
        for xb, nb in zip(xbs, n_binss)
    )


def _hist_with_count_multi(local, xbs, SC, n_nodes, n_binss, k,
                           count_from_stats: bool):
    """Grouped level histograms ``[L, m, d_g, nb_g, k+1]``. When the stat
    columns sum to the count column exactly (classification: S =
    one_hot(y) * w, C = w), the count histogram is the sum over the class
    histograms, and the stats are small integers (one-hots times bootstrap
    counts below 128): the kernel's exact int32 path."""
    if not count_from_stats:
        return _level_histogram_multi(local, xbs, SC, n_nodes, n_binss)
    Hs = _level_histogram_multi(local, xbs, SC[..., :k], n_nodes, n_binss,
                                integer_stats=True)
    return tuple(torch.cat([H, H.sum(-1, keepdim=True)], dim=-1) for H in Hs)


def _hist_with_count(local, xb, SC, n_nodes, n_bins, k, count_from_stats: bool):
    """Single-group level histogram ``[L, m, d, nb, k+1]``."""
    return _hist_with_count_multi(local, (xb,), SC, n_nodes, (n_bins,), k,
                                  count_from_stats)[0]


# ---------------------------------------------------------------------------
# split search
# ---------------------------------------------------------------------------


def _neg_inf(x):
    return torch.full_like(x, -float("inf"))


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum_k x_k^2 over the last axis, added left to right (the order of
    XLA's CPU reduce, so near-ties resolve as in the reference)."""
    acc = x[..., 0] * x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j] * x[..., j]
    return acc


def _split_gain(H, k: int, n_bins: int, min_samples_leaf: float):
    """Per-(node, feature, bin) gain from histograms ``[..., d, n_bins,
    k+1]`` (stats + count): ``[..., d, n_bins]`` with invalid candidates at
    -inf. Prefix sums over bins are cumulative sums: exact for integer
    stats, added in bin order for float stats (the reference's triangular
    contraction adds the same terms; its order is XLA's)."""
    Scum = torch.cumsum(H[..., :k], dim=-2)
    Ccum = torch.cumsum(torch.clamp(H[..., k], min=0.0), dim=-1)
    S_tot = Scum[..., -1:, :]
    C_tot = Ccum[..., -1:]
    Sr = S_tot - Scum
    Cr = C_tot - Ccum
    gain = (_sum_squares(Scum) / torch.clamp(Ccum, min=_EPS)
            + _sum_squares(Sr) / torch.clamp(Cr, min=_EPS))
    parent = _sum_squares(S_tot) / torch.clamp(C_tot, min=_EPS)
    valid = (Ccum >= min_samples_leaf) & (Cr >= min_samples_leaf)
    # last bin = degenerate split (empty right)
    valid = valid & (torch.arange(n_bins, device=H.device) < n_bins - 1)
    return torch.where(valid, gain - parent, _neg_inf(gain))


def _pick_best(gain, n_bins: int):
    """First-index argmax over (feature, bin) per node: (gain, feat, bin)."""
    flat = gain.reshape(*gain.shape[:-2], -1)
    best = torch.argmax(flat, dim=-1)
    bg = torch.gather(flat, -1, best[..., None])[..., 0]
    return bg, best // n_bins, best % n_bins


def _feature_subset_allowed(node_ids, key, max_features: Optional[int], d: int):
    """``[..., m, d]`` mask of each node's random feature subset, drawn from
    ``fold_in(key, arena id)`` (None when all features are allowed)."""
    if max_features is None or max_features >= d:
        return None
    u = prng.uniform(prng.fold_in(key, torch.clamp(node_ids, min=0)), (d,))
    thresh = torch.sort(u, dim=-1).values[..., max_features - 1 : max_features]
    return u <= thresh


def _lane_codes(xb, feat):
    """``xb[r, feat[l, r]]`` for every lane and row: ``[L, n]``."""
    n, d = xb.shape
    rows = torch.arange(n, device=xb.device) * d
    return torch.take(xb, rows + feat)


def _level_splits(H, key, k: int, n_bins: int, min_samples_leaf: float,
                  max_features: Optional[int]):
    """A complete tree level's splits from its histograms ``H [L, m, d,
    n_bins, k+1]``: (the key left after the level's feature-subset draw,
    feature, bin), both ``[L, m]``; a node with no positive gain gets the
    never-taken split (feature 0, the last bin)."""
    L, n_nodes, d = H.shape[:3]
    gain = _split_gain(H, k, n_bins, min_samples_leaf)
    if max_features is not None and max_features < d:
        key, sub = prng.split(key).unbind(-2)
        u = prng.uniform(sub, (n_nodes, d))  # [n_nodes, d] or [L, n_nodes, d]
        thresh = torch.sort(u, dim=-1).values[..., max_features - 1 : max_features]
        allowed = (u <= thresh).expand(L, n_nodes, d)
        gain = torch.where(allowed[..., None], gain, _neg_inf(gain))
    best_gain, bf, bb = _pick_best(gain, n_bins)
    do_split = best_gain > 1e-7
    return key, torch.where(do_split, bf, 0), torch.where(do_split, bb, n_bins - 1)


# ---------------------------------------------------------------------------
# complete-tree builder
# ---------------------------------------------------------------------------

#: leaves up to which float leaf sums are a one-hot contraction (the JAX
#: package's ``_LOOKUP_M``, ops/trees.py:432)
_LOOKUP_M = 256
#: elements of the leaf one-hot one chunk of rows builds (256 MiB in f32)
_LEAF_ONEHOT_ELEMS = 1 << 26


def _leaf_sums(leaf_local, SC, n_leaves: int, exact: bool):
    """Per-lane leaf sums ``[L, n_leaves, kk]`` of ``SC [L, n, kk]`` by
    ``leaf_local [L, n]``. Float stats up to ``_LOOKUP_M`` leaves take the
    JAX package's ``one_hot(leaf).T @ SC`` (ops/trees.py:465), in chunks of
    rows whose one-hot holds at most ``_LEAF_ONEHOT_ELEMS`` elements,
    summed in row order: products that sum in a fixed order, so a run on
    the card repeats its bits (a CUDA ``scatter_add_`` adds in whatever
    order its atomics land). Integer-valued stats (``exact``: sums exact in
    any order) and wider trees keep the scatter, as the reference's
    segment_sum."""
    L, n, kk = SC.shape
    out = torch.zeros((L, n_leaves, kk), dtype=torch.float32, device=SC.device)
    if exact or n_leaves > _LOOKUP_M:
        return out.scatter_add_(1, leaf_local[..., None].expand(-1, -1, kk), SC)
    leaves = torch.arange(n_leaves, device=SC.device)
    rows = max(1, _LEAF_ONEHOT_ELEMS // max(1, L * n_leaves))
    for r0 in range(0, n, rows):
        oh = (leaf_local[:, r0:r0 + rows, None] == leaves).to(SC.dtype)
        out += torch.bmm(oh.transpose(1, 2), SC[:, r0:r0 + rows])
    return out


def build_tree(xb, S, C, *, depth: int, n_bins: int, min_samples_leaf: float = 1.0,
               max_features: Optional[int] = None, key=None,
               count_from_stats: bool = False) -> Dict[str, torch.Tensor]:
    """Fit one complete tree per lane.

    xb [n, d] int32 codes (shared); S [L, n, k] weighted stats; C [L, n]
    weights (0 = not in this fit). Returns {"split_feat", "split_bin"
    [L, 2^depth-1], "leaf_val" [L, 2^depth, k], "leaf_weight" [L, 2^depth]}.
    ``key`` [2] is shared by the lanes (one tree key per forest member);
    a ``[L, 2]`` key gives each lane its own feature-subset stream (one
    boosting stage's per-class trees folded into lanes)."""
    L, n, k = S.shape
    d = xb.shape[1]
    dev = S.device
    S = S.to(torch.float32)
    C = C.to(torch.float32)
    n_internal = 2**depth - 1
    split_feat = torch.zeros((L, n_internal), dtype=torch.int64, device=dev)
    split_bin = torch.full((L, n_internal), n_bins - 1, dtype=torch.int64, device=dev)
    node = torch.zeros((L, n), dtype=torch.int64, device=dev)
    SC = torch.cat([S, C[..., None]], dim=-1)  # [L, n, k+1]

    H_prev = None
    for level in range(depth):
        n_nodes = 2**level
        base = n_nodes - 1
        local = node - base
        if level == 0:
            H = _hist_with_count(local, xb, SC, n_nodes, n_bins, k, count_from_stats)
        else:
            # left children only, right = parent - left (exact for integers)
            went_left = (local % 2 == 0).to(SC.dtype)
            H_left = _hist_with_count(local // 2, xb, SC * went_left[..., None],
                                      n_nodes // 2, n_bins, k, count_from_stats)
            H = torch.stack([H_left, H_prev - H_left], dim=2).reshape(
                L, n_nodes, d, n_bins, k + 1)
        H_prev = H
        key, bf, bb = _level_splits(H, key, k, n_bins, min_samples_leaf, max_features)
        split_feat[:, base : base + n_nodes] = bf
        split_bin[:, base : base + n_nodes] = bb
        go_left = (_lane_codes(xb, split_feat.gather(1, node))
                   <= split_bin.gather(1, node))
        node = 2 * node + 1 + (~go_left).long()

    leaf_local = node - n_internal
    SCl = _leaf_sums(leaf_local, SC, 2**depth, count_from_stats)
    Sl, Cl = SCl[..., :k], SCl[..., k]
    return {
        "split_feat": split_feat,
        "split_bin": split_bin,
        "leaf_val": Sl / torch.clamp(Cl, min=_EPS)[..., None],
        "leaf_weight": Cl,
    }


# ---------------------------------------------------------------------------
# out-of-core streamed builder
# ---------------------------------------------------------------------------
#
# build_tree's per-level work is two row reductions (the level histogram
# and, at the end, the leaf stat sums) plus node-level math. Both are sums
# over rows, so they block-accumulate: one streamed pass per level (route
# the pending previous-level split, then add the block's histogram), one
# final pass for the last routing and the leaf sums — depth + 1 passes,
# with resident state only the node ids [L, n_pad] and stats [L, n_pad,
# k+1]. On the card every level block is one launch of kernel B4 (int32
# mode for integer stats). For integer stats every partial sum is exact,
# so the streamed tree equals build_tree's to the bit (JAX
# ``ops/trees.py:660-850``).


def _stream_tree_level_fn(k: int, n_bins: int, level: int, count_from_stats: bool):
    """One block's step of streamed level ``level``: apply the pending
    previous-level routing to the block's rows, then add the block's
    contribution to the level histogram (left children only past the root:
    the subtraction trick runs after the pass, on the summed histogram, as
    in build_tree)."""
    n_nodes = 2**level
    base = n_nodes - 1

    def fn(carry, SC, bf, bb, xb_b, start):
        node, H = carry
        rows = xb_b.shape[0]
        nb = node[:, start:start + rows]
        scb = SC[:, start:start + rows]
        if level > 0:
            lp = nb - (n_nodes // 2 - 1)
            go_left = _lane_codes(xb_b, bf.gather(1, lp)) <= bb.gather(1, lp)
            nb = 2 * nb + 1 + (~go_left).long()
            node[:, start:start + rows] = nb
        local = nb - base
        if level == 0:
            Hb = _hist_with_count(local, xb_b, scb, n_nodes, n_bins, k, count_from_stats)
        else:
            went_left = (local % 2 == 0).to(scb.dtype)
            Hb = _hist_with_count(local // 2, xb_b, scb * went_left[..., None],
                                  n_nodes // 2, n_bins, k, count_from_stats)
        return node, H + Hb

    return fn


def _stream_tree_leaf_fn(k: int, depth: int, exact: bool = False):
    """The final streamed pass: apply the last level's pending routing,
    then add the block's per-leaf stat sums (``exact``: integer-valued
    stats, as ``build_tree``'s ``count_from_stats``)."""
    n_internal = 2**depth - 1
    prev_base = 2 ** (depth - 1) - 1

    def fn(carry, SC, bf, bb, xb_b, start):
        node, SCl = carry
        rows = xb_b.shape[0]
        nb = node[:, start:start + rows]
        scb = SC[:, start:start + rows]
        lp = nb - prev_base
        go_left = _lane_codes(xb_b, bf.gather(1, lp)) <= bb.gather(1, lp)
        nb = 2 * nb + 1 + (~go_left).long()
        node[:, start:start + rows] = nb
        return node, SCl + _leaf_sums(nb - n_internal, scb, 2**depth, exact)

    return fn


def build_tree_streamed(stream_pass, S, C, d: int, *, depth: int, n_bins: int,
                        min_samples_leaf: float = 1.0, max_features: Optional[int] = None,
                        key=None, count_from_stats: bool = False):
    """build_tree over streamed row blocks: depth + 1 passes, identical
    split and leaf math.

    ``stream_pass(fn, carry, *consts)`` runs one ascending pass over the
    bin-code blocks, folding ``carry = fn(carry, *consts, xb_b, start)``
    per block. ``S [L, n_pad, k]`` / ``C [L, n_pad]`` are the full padded
    per-sample stats and weights — zero on pad rows, which land in node
    0's histograms and add nothing, like a zero-count sample in
    build_tree. The per-level feature subsets consume ``key`` in
    build_tree's split order, so the draws are the same bits.

    Returns ``(tree, node)``: ``tree`` as build_tree's dict, ``node`` the
    final node id of every row and lane ``[L, n_pad]``, so predictions for
    the fitted rows are a leaf lookup, with no pass over the data."""
    if depth < 1:
        raise ValueError("build_tree_streamed requires depth >= 1")
    L, n_pad, k = S.shape
    dev = S.device
    SC = torch.cat([S.to(torch.float32), C.to(torch.float32)[..., None]], dim=-1)
    n_internal = 2**depth - 1
    split_feat = torch.zeros((L, n_internal), dtype=torch.int64, device=dev)
    split_bin = torch.full((L, n_internal), n_bins - 1, dtype=torch.int64, device=dev)
    node = torch.zeros((L, n_pad), dtype=torch.int64, device=dev)

    H_prev = None
    bf = bb = torch.zeros((L, 1), dtype=torch.int64, device=dev)
    for level in range(depth):
        n_nodes = 2**level
        base = n_nodes - 1
        fn = _stream_tree_level_fn(k, n_bins, level, count_from_stats)
        H0 = torch.zeros((L, max(n_nodes // 2, 1), d, n_bins, k + 1), dtype=torch.float32,
                         device=dev)
        node, Hl = stream_pass(fn, (node, H0), SC, bf, bb)
        if level == 0:
            H = Hl
        else:
            H = torch.stack([Hl, H_prev - Hl], dim=2).reshape(L, n_nodes, d, n_bins, k + 1)
        H_prev = H
        key, bf, bb = _level_splits(H, key, k, n_bins, min_samples_leaf, max_features)
        split_feat[:, base : base + n_nodes] = bf
        split_bin[:, base : base + n_nodes] = bb

    SCl0 = torch.zeros((L, 2**depth, k + 1), dtype=torch.float32, device=dev)
    node, SCl = stream_pass(_stream_tree_leaf_fn(k, depth, count_from_stats), (node, SCl0),
                            SC, bf, bb)
    Sl, Cl = SCl[..., :k], SCl[..., k]
    tree = {
        "split_feat": split_feat,
        "split_bin": split_bin,
        "leaf_val": Sl / torch.clamp(Cl, min=_EPS)[..., None],
        "leaf_weight": Cl,
    }
    return tree, node


# ---------------------------------------------------------------------------
# deep arena builder
# ---------------------------------------------------------------------------

#: features with at most this many bin codes qualify for the deep builder's
#: narrow coarse-histogram group (one-hot/binary columns: 2 codes)
COARSE_BINS = int(os.environ.get("CS230_COARSE_BINS", "4"))


def build_tree_deep(xb, S, C, *, levels: int, width: int, n_bins: int,
                    min_samples_leaf: float = 1.0, max_features: Optional[int] = None,
                    key=None, count_from_stats: bool = False,
                    groups: Optional[Dict[str, torch.Tensor]] = None,
                    w_schedule: Optional[Tuple[int, int, int]] = None,
                    nb_schedule: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Deep tree per lane by frontier-compacted level-wise growth.

    Per level: split every frontier node whose best gain is positive (while
    the arena has room: ``n_alloc + 2 * rank <= A``), histogram the LEFT
    children by parent slot in one launch, derive the right ones by
    subtraction, and keep the top ``width`` children by their own best
    gain as the next frontier. ``groups`` histograms low-cardinality
    features at ``COARSE_BINS``; ``nb_schedule`` (occ_w, nb_deep) drops
    candidate resolution to ``nb_deep`` once the candidate frontier
    reaches ``occ_w`` (coarse bins are sums of adjacent fine bins, split
    records stay in fine units); ``w_schedule`` (hi, split_level, lo)
    narrows the frontier past ``split_level``. Both come from the kernel's
    resolved static; the sweep hooks ``CS230_DEEP_WSCHED`` (``hi:split:lo``)
    and ``CS230_DEEP_NBSCHED`` (``occ_w:nb_deep``) take precedence, as in
    the reference (the tree kernels key them in ``trace_salt``).

    Returns per lane {"feat", "bin", "child" [L, A+1], "leaf_val" [L, A+1,
    k], "leaf_weight" [L, A+1], and the per-level routing tables
    "level_ids", "level_feat", "level_bin", "level_left" [L, levels,
    width]}; ``child`` is the left child's arena id (0 = leaf)."""
    L, n, k = S.shape
    d = xb.shape[1]
    dev = S.device
    S = S.to(torch.float32)
    C = C.to(torch.float32)
    sched = os.environ.get("CS230_DEEP_WSCHED", "")
    if sched:
        w_schedule = tuple(int(x) for x in sched.split(":"))
    if w_schedule is not None:
        w_hi, w_split, w_lo = (int(x) for x in w_schedule)
        width_at = lambda lvl: w_hi if lvl < w_split else w_lo  # noqa: E731
        width = max(w_hi, w_lo)
    else:
        width_at = lambda lvl: width  # noqa: E731
    A = 2 * width * levels + 2  # arena capacity; index A = scratch slot
    SC = torch.cat([S, C[..., None]], dim=-1)
    if key is None:
        key = prng.PRNGKey(0, device=dev)

    i64 = dict(dtype=torch.int64, device=dev)
    feat_a = torch.zeros((L, A + 1), **i64)
    bin_a = torch.full((L, A + 1), n_bins - 1, **i64)
    child_a = torch.zeros((L, A + 1), **i64)
    node = torch.zeros((L, n), **i64)
    n_alloc = torch.ones((L,), **i64)
    lvl_ids, lvl_feat, lvl_bin, lvl_left = [], [], [], []

    # feature groups: (codes, global feature ids or None, bin count)
    if groups is not None:
        gspec = (
            (groups["xb_cont"], groups["fid_cont"].long(), n_bins),
            (groups["xb_coarse"], groups["fid_coarse"].long(), COARSE_BINS),
        )
    else:
        gspec = ((xb, None, n_bins),)

    nbsched = os.environ.get("CS230_DEEP_NBSCHED", "")
    if nbsched:
        nb_schedule = tuple(int(x) for x in nbsched.split(":"))
    if nb_schedule is not None:
        occ_w, nb_deep = (int(x) for x in nb_schedule)
        if nb_deep <= 0 or n_bins % max(nb_deep, 1) or nb_deep > n_bins:
            raise ValueError(f"nb_schedule deep bins {nb_deep} must divide n_bins {n_bins}")
    else:
        occ_w, nb_deep = 0, n_bins

    def res_at(cand_w: int) -> int:
        return n_bins if (occ_w <= 0 or cand_w < occ_w) else nb_deep

    def g_res(r: int, nbg: int) -> int:
        return r if nbg == n_bins else nbg  # only full-resolution groups follow r

    def coarsen(H, r_from: int, r_to: int):
        if r_from == r_to:
            return H
        *lead, dg, _, kkp = H.shape
        return H.reshape(*lead, dg, r_to, r_from // r_to, kkp).sum(-2)

    def hist_groups(local, m, r):
        xgs = tuple(xg if g_res(r, nbg) == nbg else xg // (nbg // r)
                    for xg, _, nbg in gspec)
        nbs = tuple(g_res(r, nbg) for _, _, nbg in gspec)
        return _hist_with_count_multi(local, xgs, SC, m, nbs, k, count_from_stats)

    def best_from_hists(Hs, node_ids, r):
        """Per node best (gain, GLOBAL feature, FINE bin) over the groups;
        ties keep the earlier group."""
        allowed = _feature_subset_allowed(node_ids, key, max_features, d)
        best = None
        for Hg, (_, fidg, nbg) in zip(Hs, gspec):
            rg = g_res(r, nbg)
            g = _split_gain(Hg, k, rg, min_samples_leaf)
            if allowed is not None:
                ag = allowed if fidg is None else allowed[..., fidg]
                g = torch.where(ag[..., None], g, _neg_inf(g))
            bg, bfl, bbl = _pick_best(g, rg)
            if rg != nbg:
                bbl = (bbl + 1) * (nbg // rg) - 1  # last fine code of coarse bin
            bfg = bfl if fidg is None else fidg[bfl]
            if best is None:
                best = (bg, bfg, bbl)
            else:
                new = bg > best[0]
                best = (torch.maximum(bg, best[0]), torch.where(new, bfg, best[1]),
                        torch.where(new, bbl, best[2]))
        return best

    lanes = torch.arange(L, device=dev)[:, None]
    frontier = torch.zeros((L, 1), **i64)
    r_H = res_at(2)
    H = hist_groups(node, 1, r_H)
    gain, bf, bb = best_from_hists(H, frontier, r_H)

    for level in range(levels):
        W_l = frontier.shape[1]
        do_split = (gain > 1e-7) & (frontier >= 0)
        rank_inc = torch.cumsum(do_split.long(), dim=1)
        do_split = do_split & (n_alloc[:, None] + 2 * rank_inc <= A)
        rank_inc = torch.cumsum(do_split.long(), dim=1)
        rank_exc = rank_inc - do_split.long()
        left_id = n_alloc[:, None] + 2 * rank_exc

        # split records; masked entries land in the scratch slot A
        idx = torch.where(do_split, frontier, A)
        feat_a.scatter_(1, idx, torch.where(do_split, bf, 0))
        bin_a.scatter_(1, idx, torch.where(do_split, bb, n_bins - 1))
        child_a.scatter_(1, idx, torch.where(do_split, left_id, 0))

        # route rows sitting in split nodes to their children: the slot of
        # each row's node in the frontier, by a table lookup per lane
        slot_tab = torch.full((L, A + 1), W_l, **i64)
        slot_tab.scatter_(1, torch.where(frontier >= 0, frontier, A),
                          torch.arange(W_l, device=dev).expand(L, W_l).contiguous())
        slot_tab[:, A] = W_l
        slot = slot_tab.gather(1, node)
        sc = torch.clamp(slot, max=W_l - 1)
        in_split = (slot < W_l) & do_split.gather(1, sc)
        go_left = _lane_codes(xb, bf.gather(1, sc)) <= bb.gather(1, sc)
        node = torch.where(in_split, left_id.gather(1, sc) + 1 - go_left.long(), node)
        n_alloc = n_alloc + 2 * rank_inc[:, -1]

        pad = width - W_l
        lvl_ids.append(torch.nn.functional.pad(
            torch.where(do_split, frontier, -1), (0, pad), value=-1))
        lvl_feat.append(torch.nn.functional.pad(bf, (0, pad)))
        lvl_bin.append(torch.nn.functional.pad(bb, (0, pad)))
        lvl_left.append(torch.nn.functional.pad(left_id, (0, pad)))

        if level == levels - 1:
            break  # children of the last level are leaves

        local_left = torch.where(in_split & go_left, slot, W_l)
        r_c = min(r_H, res_at(2 * W_l))
        if r_c != r_H:
            H = tuple(coarsen(h, g_res(r_H, nbg), g_res(r_c, nbg))
                      for h, (_, _, nbg) in zip(H, gspec))
            r_H = r_c
        H_L = hist_groups(local_left, W_l, r_c)
        cand_H = tuple(torch.cat([hl, h - hl], dim=1) for h, hl in zip(H, H_L))
        cand_id = torch.cat([torch.where(do_split, left_id, -1),
                             torch.where(do_split, left_id + 1, -1)], dim=1)
        cgain, cbf, cbb = best_from_hists(cand_H, cand_id, r_c)
        cgain = torch.where(cand_id >= 0, cgain, _neg_inf(cgain))

        # lax.top_k: largest first, the lower index first among equals
        W_next = min(2 * W_l, width_at(level + 1))
        vals, sel = torch.sort(cgain, dim=1, descending=True, stable=True)
        vals, sel = vals[:, :W_next], sel[:, :W_next]
        frontier = torch.where(vals > -float("inf"), cand_id.gather(1, sel), -1)
        gain = vals
        bf = cbf.gather(1, sel)
        bb = cbb.gather(1, sel)
        H = tuple(h[lanes, sel] for h in cand_H)

    leaf_S = torch.zeros((L, A + 1, k), dtype=torch.float32, device=dev)
    leaf_S.scatter_add_(1, node[..., None].expand(-1, -1, k), S)
    leaf_C = torch.zeros((L, A + 1), dtype=torch.float32, device=dev)
    leaf_C.scatter_add_(1, node, C)
    return {
        "feat": feat_a,
        "bin": bin_a,
        "child": child_a,
        "leaf_val": leaf_S / torch.clamp(leaf_C, min=_EPS)[..., None],
        "leaf_weight": leaf_C,
        "level_ids": torch.stack(lvl_ids, dim=1),
        "level_feat": torch.stack(lvl_feat, dim=1),
        "level_bin": torch.stack(lvl_bin, dim=1),
        "level_left": torch.stack(lvl_left, dim=1),
    }


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------


def _route_deep_levels(xb, level_ids, level_feat, level_bin, level_left,
                       levels: int, n_arena: int):
    """Arena walk by the per-level routing tables: ``[L, n]`` leaf ids. At
    step l a row advances iff its node was split at level l (each node is
    split at most once). The node's slot in the level's table is looked up
    by arena id."""
    L, n = level_ids.shape[0], xb.shape[0]
    dev = xb.device
    node = torch.zeros((L, n), dtype=torch.int64, device=dev)
    for lvl in range(levels):
        ids = level_ids[:, lvl]
        W = ids.shape[1]
        tab = torch.full((L, n_arena + 1), W, dtype=torch.int64, device=dev)
        tab.scatter_(1, torch.where(ids >= 0, ids, n_arena),
                     torch.arange(W, device=dev).expand(L, W).contiguous())
        tab[:, n_arena] = W
        slot = tab.gather(1, node)
        sc = torch.clamp(slot, max=W - 1)
        go_left = (_lane_codes(xb, level_feat[:, lvl].gather(1, sc))
                   <= level_bin[:, lvl].gather(1, sc))
        node = torch.where(slot < W,
                           level_left[:, lvl].gather(1, sc) + 1 - go_left.long(), node)
    return node


def _gather_leaf(leaf_val, leaf):
    k = leaf_val.shape[-1]
    return leaf_val.gather(1, leaf[..., None].expand(-1, -1, k))


def predict_tree_deep(xb, tree, levels: int, n_bins: int = 0):
    """Leaf values ``[L, n, k]`` of binned rows against arena trees, walked
    by their per-level routing tables."""
    leaf = _route_deep_levels(
        xb, tree["level_ids"], tree["level_feat"], tree["level_bin"],
        tree["level_left"], levels, tree["leaf_val"].shape[1] - 1)
    return _gather_leaf(tree["leaf_val"], leaf)


def _route(xb, split_feat, split_bin, depth: int):
    """Complete-tree walk: ``[L, n]`` leaf index per row and lane."""
    L, n = split_feat.shape[0], xb.shape[0]
    node = torch.zeros((L, n), dtype=torch.int64, device=xb.device)
    for _ in range(depth):
        go_left = (_lane_codes(xb, split_feat.gather(1, node))
                   <= split_bin.gather(1, node))
        node = 2 * node + 1 + (~go_left).long()
    return node - (2**depth - 1)


def predict_tree(xb, tree, depth: int, n_bins: int = 0):
    """Leaf values ``[L, n, k]`` of binned rows against complete trees."""
    return _gather_leaf(tree["leaf_val"],
                        _route(xb, tree["split_feat"], tree["split_bin"], depth))
