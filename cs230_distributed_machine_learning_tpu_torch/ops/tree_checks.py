"""Tie-aware comparison of complete histogram trees built from float stats.

Used where two fits of one tree add in other orders: the CPU tests hold
the port against the JAX package (tests/test_torch_boosting.py,
tests/test_torch_tree_families.py), chip_smoke.py holds the card against
the CPU. With float stats (regression targets, boosting gradients and
hessians) the bin prefix sums are added in other orders (XLA's triangular
contraction against torch's cumsum; B4's split contraction on the card
against the plain version's row order), so a split whose best gain leads
the next by a few ulps of the node's own S^2/C term may go either way.
Candidates that cut a node's rows into the same two sets tie exactly, and
rounding breaks the tie (across empty bins too: the reference may take the
later bin). Such close calls are found from full level histograms of the
rows the reference tree routes to each node, and the subtree below each
one is not compared; every other split must be equal and every compared
leaf value within LEAF_TOL.
"""

import numpy as np
import torch

from ..utils import prng
from . import trees as tt

#: relative band of the node's own S^2/C term within which a call is close
LEAD = 1e-5
#: band around min_samples_leaf within which a side's count (a hessian sum
#: in boosting) may round to either side of it
COUNT_BAND = 1e-4
LEAF_TOL = 1e-5


def close_calls(xb, S, C, feat, bins, *, depth, n_bins, msl=1.0, mf=None, key=None):
    """Per internal node of a reference tree (one lane; xb [n, d], S [n, k],
    C [n], feat / bins its split records): whether its split is a close
    call. A call is close where, within LEAD of the node's own term
    ``sum_k S_tot^2 / C_tot`` (a gain is a difference of such terms, and
    rounds with them), the best allowed gain ties another candidate (even
    one bin further across empty bins: the reference rounds each prefix sum
    on its own), or the split threshold (1e-7), or a candidate whose side's
    count lies within
    COUNT_BAND of min_samples_leaf could win (right children are parent
    minus left in both packages, and that subtraction rounds non-integer
    counts differently in each). ``mf`` / ``key``: the builder's max_features and
    tree key, whose per-level feature subsets are redrawn here."""
    n, d = xb.shape
    k = S.shape[1]
    node = np.zeros(n, np.int64)
    SC = torch.as_tensor(np.concatenate([S, C[:, None]], axis=1), dtype=torch.float32)[None]
    xbt = torch.as_tensor(xb)
    close = np.zeros(2**depth - 1, bool)
    for level in range(depth):
        m = 2**level
        base = m - 1
        H = tt._hist_with_count(torch.as_tensor(node - base)[None], xbt, SC, m, n_bins, k,
                                False)[0].double()
        g = tt._split_gain(H[None], k, n_bins, msl)[0]
        g_any = tt._split_gain(H[None], k, n_bins, 0.0)[0]  # validity aside
        Ccum = torch.cumsum(H[..., k], dim=-1)
        Cr = Ccum[..., -1:] - Ccum
        band_c = COUNT_BAND * max(msl, 1.0)
        border = ((Ccum - msl).abs() <= band_c) | ((Cr - msl).abs() <= band_c)
        border &= not np.array_equal(C, np.round(C))  # integer counts sum exactly
        if mf is not None:
            key, sub = prng.split(key).unbind(-2)
            u = prng.uniform(sub, (m, d))
            allowed = (u <= torch.sort(u, dim=-1).values[:, mf - 1 : mf])[..., None]
            g = torch.where(allowed, g, -np.inf)
            border &= allowed
        flat = g.reshape(m, -1).numpy()
        best_border = torch.where(border, g_any, -np.inf).reshape(m, -1).amax(-1).numpy()
        tot = H[:, 0].sum(dim=1)  # [m, k + 1]
        own = ((tot[:, :k] ** 2).sum(-1) / tot[:, k].clamp(min=1e-12)).numpy()
        for i in range(m):
            top = flat[i].max()
            band = LEAD * max(own[i], abs(top) if np.isfinite(top) else 0.0, 1e-7)
            if not np.isfinite(top):
                close[base + i] = np.isfinite(best_border[i])
                continue
            close[base + i] = (np.count_nonzero(flat[i] >= top - band) > 1
                               or abs(top - 1e-7) <= band
                               or best_border[i] >= top - band)
        go_left = xb[np.arange(n), feat[node]] <= bins[node]
        node = 2 * node + 1 + (~go_left)
    return close


def check_tree(xb, S, C, ref, got, **kw):
    """A port tree ``got`` against the reference tree ``ref`` (one lane, numpy
    split_feat / split_bin / leaf_val): splits equal but at close calls,
    whose subtrees are skipped, compared leaves within LEAF_TOL. ``kw`` as
    ``close_calls``. Returns the number of close calls."""
    jf, jb = np.asarray(ref["split_feat"]), np.asarray(ref["split_bin"])
    is_close = close_calls(xb, S, C, jf, jb, **kw)
    n_int = len(jf)
    skip = np.zeros(2 * n_int + 1, bool)  # a close call at or above the node
    n_close = 0
    for i in range(2 * n_int + 1):
        if i and skip[(i - 1) // 2]:
            skip[i] = True
        elif i < n_int and is_close[i]:
            skip[i] = True
            n_close += 1
        elif i < n_int:
            assert got["split_feat"][i] == jf[i] and got["split_bin"][i] == jb[i], i
        else:
            np.testing.assert_allclose(got["leaf_val"][i - n_int],
                                       np.asarray(ref["leaf_val"][i - n_int]),
                                       rtol=LEAF_TOL, atol=LEAF_TOL)
    return n_close
