"""B4's f32 mode (csrc/hist.cu: the split one-hot contraction) on the CPU:
its exact stat split, its route arithmetic and its arithmetic in plain
form, against the JAX package's level histograms fed the same numpy inputs.

The kernel runs on the card only (tests/test_torch_kernels_gpu.py). Here:
(a) ``split_stats_reference`` gives three bf16 terms whose f32 sum is the
stat to the bit (gradients, hessians floored at 1e-12, normal draws); two
terms alone do not. (b) ``f32_plan`` (the route by the cost of the whole
launch, the lanes a launch, the K splits) and the shared-memory and
scratch sizes are plain shape arithmetic, held for every boosting, refit,
deep-level and crossover shape: each fits the card's 232,448 bytes, the
launches take every lane once within the scratch cap, the K splits cover
every row once, the dense grid fills the SMs, the route picked is the
cheaper, and the page route's steps stay within the bound its scratch is
sized by.
(c) ``level_histogram_reference`` and ``split_contraction_reference`` by
both routes agree with the JAX package's ``level_histogram_pallas``
(interpret mode) and ``level_histogram_scatter`` within 1e-5 of the
histogram's max (f32 sums in other orders) on boosting inputs cut small.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.ops.pallas_hist import (
    level_histogram_pallas,
    level_histogram_scatter,
)
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as H
from cs230_distributed_machine_learning_tpu_torch.ops import kernel_cases as kc

torch.set_num_threads(1)

F32_SHAPES = {**kc.HIST_FLOAT_SHAPES, **kc.HIST_FLOAT_REFIT_SHAPES,
              **kc.HIST_FLOAT_DEEP_SHAPES, **kc.HIST_FLOAT_CROSSOVER_SHAPES}


def _boosting_stats(rng, L, n):
    """Log-loss gradients y - p and hessians max(p (1 - p), 1e-12) of an
    80 % subsample (the rest: a zero gradient and the floor)."""
    p = rng.rand(L, n).astype(np.float32)
    y = (rng.rand(L, n) < p).astype(np.float32)
    m = (rng.rand(L, n) < 0.8).astype(np.float32)
    return np.stack([(y - p) * m, np.maximum(p * (1 - p) * m, np.float32(1e-12))], axis=-1)


@pytest.mark.parametrize("kind", ["boosting", "normal", "tiny"])
def test_three_bf16_terms_sum_to_the_stat_bit_for_bit(kind):
    rng = np.random.RandomState(0)
    if kind == "boosting":
        s = _boosting_stats(rng, 4, 50_000)
    elif kind == "normal":
        s = rng.randn(200_000).astype(np.float32) * np.float32(37.0)
    else:  # the hessian floor and values near 1e-30 (lo stays a normal bf16)
        s = np.concatenate([np.full(10, 1e-12, np.float32),
                            ((0.5 + rng.rand(10_000)) * 1e-30).astype(np.float32)])
    st = torch.as_tensor(s)
    hi, mid, lo = H.split_stats_reference(st)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    three = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(three, st)
    two = hi.float() + mid.float()
    if kind != "tiny":  # two terms keep 16 of the 24 bits
        assert not torch.equal(two, st)
        assert float(((two - st).abs() / st.abs().clamp_min(1e-30)).max()) > 1e-7


@pytest.mark.parametrize("tag", sorted(F32_SHAPES))
def test_route_arithmetic_fits_the_card_and_covers_every_row(tag):
    L, n, d, n_bins, n_nodes, kk = F32_SHAPES[tag]
    plan = H.f32_plan(L, n, d, n_bins, n_nodes, kk)
    assert plan.route in ("dense", "page")
    assert plan.route == H.f32_route(L, n, d, n_bins, n_nodes, kk)
    Fn = H.f32_features(d, n_bins)
    assert 1 <= Fn * n_bins <= H.F32_N and Fn <= d
    assert H.f32_smem_bytes(Fn) <= H.SMEM_LIMIT == 232_448
    for route in ("dense", "page"):  # launches take every lane once, each within the cap
        p = H.f32_plan(L, n, d, n_bins, n_nodes, kk, route)
        assert p.route == route and plan.cost <= p.cost
        assert p.launches == -(-L // p.lanes) and (p.launches - 1) * p.lanes < L
        for lanes in {p.lanes, L - (p.launches - 1) * p.lanes}:
            splits = H.f32_launch(route, lanes, n, d, n_bins, n_nodes, kk)[1]
            ints = H.f32_scratch_ints(lanes, n, d, n_bins, kk, n_nodes, route, splits)
            assert 0 < 4 * ints <= H.F32_SCRATCH_BYTES or lanes == 1
    if plan.route == "dense":
        ranges = H.f32_split_rows(n, plan.splits)
        assert len(ranges) == plan.splits
        covered = np.zeros(n, np.int64)
        for r0, r1 in ranges:
            assert r0 <= r1 and (r0 % H.F32_K == 0 or r0 == r1 == n)  # whole K steps
            covered[r0:r1] += 1
        assert (covered == 1).all()
        ksteps = -(-n // H.F32_K)
        assert plan.ctas >= H.SMS or plan.splits == min(H.F32_MAX_SPLITS, ksteps)
        assert plan.splits <= ksteps
    else:
        assert plan.splits == 1 and H.f32_page_nodes(kk) * kk <= H.F32_M


@pytest.mark.parametrize("n_nodes,route", [(1, "dense"), (2, "dense"), (4, "dense"),
                                           (16, "dense"), (32, "page"), (64, "page"),
                                           (128, "page")])
def test_route_rule_prices_the_whole_launch(n_nodes, route):
    """At boosting's 168 lanes on covertype: the dense route's cost grows
    with the (node, stat) rows it batches into M, the page route's stays
    about one tile a lane over the live rows (half of them past the root),
    so from 32 nodes the levels go to pages (on the H100: dense 33.4 ms,
    page 36.7 at 16 nodes; 66.5 and 36.6 at 32; 133.4 and 36.5 at 64);
    a 64-node level's dense scratch (15 GB in one launch) and every other
    level's run in launches within the cap, and ``f32_lane_bytes`` bounds
    a lane's share of the picked route's scratch."""
    L, n, d, n_bins, kk = 168, 116_202, 54, 128, 2
    plan = H.f32_plan(L, n, d, n_bins, n_nodes, kk)
    assert plan.route == route
    dense = [H.f32_plan(L, n, d, n_bins, m, kk, "dense").cost for m in (n_nodes, 2 * n_nodes)]
    page = [H.f32_plan(L, n, d, n_bins, m, kk, "page").cost for m in (n_nodes, 2 * n_nodes)]
    assert dense[1] > dense[0] and page[1] <= page[0] * 1.05
    splits = H.f32_launch(plan.route, plan.lanes, n, d, n_bins, n_nodes, kk)[1]
    ints = H.f32_scratch_ints(plan.lanes, n, d, n_bins, kk, n_nodes, plan.route, splits)
    per_lane = 4 * ints / plan.lanes
    if n_nodes * kk <= H.F32_M:
        partials = 4 * n_nodes * d * n_bins * kk * splits
        assert per_lane <= H.f32_lane_bytes(n, d, n_bins, kk) + partials
    if n_nodes == 64:
        one = H.f32_scratch_ints(L, n, d, n_bins, kk, n_nodes, "dense", 1)
        assert 4 * one > 6 * H.F32_SCRATCH_BYTES and plan.launches > 1


@pytest.mark.parametrize("kind", kc.SKEWED_LEVELS)
def test_page_route_steps_stay_within_their_bound(kind):
    """A lane's pages (runs of 64 // kk nodes) over the stable row list,
    each padded to whole K steps, take at most ceil(n / 64) + pages steps:
    the page route's A images and codes are sized for that many."""
    rng = np.random.RandomState(kc.SKEWED_LEVELS.index(kind))
    L, n, n_nodes, kk = 3, 4_000, 300, 2
    local = torch.as_tensor(kc.skewed_node_ids(kind, L, n, n_nodes, rng).astype(np.int32))
    SC = torch.as_tensor((rng.randn(L, n, kk) * (rng.rand(L, n, 1) < 0.7)).astype(np.float32))
    off, rows = H.bucket_rows_stable(local, n_nodes, SC)
    want_off, want_rows = H.bucket_rows_reference(local, n_nodes, SC)
    assert torch.equal(off, want_off) and torch.equal(rows, want_rows)
    Mb = H.f32_page_nodes(kk)
    pages = -(-n_nodes // Mb)
    for lane in range(L):
        o = off[lane].numpy()
        seg = [o[min(n_nodes, p * Mb + Mb)] - o[p * Mb] for p in range(pages)]
        steps = sum(-(-s // H.F32_K) for s in seg)
        assert sum(seg) == o[-1] and steps <= -(-n // H.F32_K) + pages
        for p in range(pages):  # ascending rows within each node of the page
            for m in range(p * Mb, min(n_nodes, p * Mb + Mb)):
                r = rows[lane, o[m]:o[m + 1]].numpy()
                assert (np.diff(r) > 0).all() and (local[lane, r].numpy() == m).all()


def _jax_histograms(local, xb, SC, n_nodes, n_bins):
    xj = jnp.asarray(xb)
    pallas = jax.vmap(lambda l, sc: level_histogram_pallas(
        l, xj, sc, n_nodes, n_bins, interpret=True))(jnp.asarray(local), jnp.asarray(SC))
    scatter = jax.vmap(lambda l, sc: level_histogram_scatter(
        l, xj, sc, n_nodes, n_bins))(jnp.asarray(local), jnp.asarray(SC))
    return np.asarray(pallas), np.asarray(scatter)


@pytest.mark.parametrize("n_nodes", [1, 2])
def test_plain_and_split_contraction_match_jax_at_boosting_levels(n_nodes):
    """Boosting's levels cut small: 6 lanes, 2,000 rows, 12 features, 128
    bins, the root (every row in node 0) or the left children of 4 nodes
    (the right children's rows zeroed, as build_tree calls the kernel)."""
    rng = np.random.RandomState(7 + n_nodes)
    L, n, d, n_bins = 6, 2_000, 12, 128
    SC = _boosting_stats(rng, L, n)
    xb = rng.randint(0, n_bins, (n, d)).astype(np.int32)
    if n_nodes == 1:
        local = np.zeros((L, n), np.int32)
    else:
        node = rng.randint(0, 2 * n_nodes, (L, n))
        local = (node // 2).astype(np.int32)
        SC = SC * (node % 2 == 0)[..., None].astype(np.float32)
    pallas, scatter = _jax_histograms(local, xb, SC, n_nodes, n_bins)
    tl, tx, ts = torch.as_tensor(local), torch.as_tensor(xb), torch.as_tensor(SC)
    scale = np.abs(scatter).max()
    got = {"plain": H.level_histogram_reference(tl, tx, ts, n_nodes, n_bins).numpy()}
    for route in ("dense", "page"):
        got[route] = H.split_contraction_reference(tl, tx, ts, n_nodes, n_bins, route).numpy()
    assert H.f32_route(L, n, d, n_bins, n_nodes, 2) == "dense"
    for name, h in got.items():
        assert h.shape == (L, n_nodes, d, n_bins, 2)
        for want in (pallas, scatter):
            assert np.abs(h - want).max() / scale < 1e-5, name


def test_split_contraction_matches_jax_at_a_deep_level():
    """A deep arena's level cut small, by both routes (at this size one
    dense wave beats the pages, so ``f32_plan`` takes dense): regression
    stats y * w and w, the left children of a 96-wide frontier, dead rows
    at the frontier's width."""
    rng = np.random.RandomState(3)
    L, n, d, n_bins, n_nodes = 2, 1_500, 5, 48, 96
    y = rng.randn(n).astype(np.float32)
    w = (rng.rand(L, n) < 0.8).astype(np.float32)
    SC = np.stack([y * w, w], axis=-1)
    xb = rng.randint(0, n_bins, (n, d)).astype(np.int32)
    local = np.where(rng.rand(L, n) < 0.5, rng.randint(0, n_nodes, (L, n)), n_nodes)
    local = local.astype(np.int32)
    assert H.f32_route(L, n, d, n_bins, n_nodes, 2) == "dense"
    pallas, scatter = _jax_histograms(local, xb, SC, n_nodes, n_bins)
    tl, tx, ts = torch.as_tensor(local), torch.as_tensor(xb), torch.as_tensor(SC)
    scale = np.abs(scatter).max()
    for route in ("page", "dense"):
        h = H.split_contraction_reference(tl, tx, ts, n_nodes, n_bins, route).numpy()
        for want in (pallas, scatter):
            assert np.abs(h - want).max() / scale < 1e-5, route


def test_float_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(5)
    L, n, d, n_bins, n_nodes = 3, 700, 4, 16, 2
    local = torch.as_tensor(rng.randint(-1, n_nodes + 1, (L, n)).astype(np.int32))
    xb = torch.as_tensor(rng.randint(0, n_bins, (n, d)).astype(np.int32))
    SC = torch.as_tensor(rng.randn(L, n, 2).astype(np.float32))
    H.reset_launches()
    got = H.level_histogram(local, xb, SC, n_nodes, n_bins)
    assert torch.equal(got, H.level_histogram_reference(local, xb, SC, n_nodes, n_bins))
    assert H.LAUNCHES["level_histogram"] == 0
    with pytest.raises(ValueError):
        H.level_histogram_f32_route(local, xb, SC, n_nodes, n_bins, "dense")


def test_leaf_sums_add_row_chunks_of_the_one_hot_product_in_order(monkeypatch):
    """Float leaf sums are the one-hot product taken over chunks of rows
    (each chunk's one-hot bounded by ``_LEAF_ONEHOT_ELEMS``) and added in
    row order: the same bits as that explicit sum, within f32 rounding of
    the exact sums; integer stats keep the scatter."""
    from cs230_distributed_machine_learning_tpu_torch.ops import trees as ot

    rng = np.random.RandomState(4)
    L, n, kk, n_leaves, rows = 3, 1_000, 2, 8, 64
    leaf = torch.as_tensor(rng.randint(0, n_leaves, (L, n)))
    SC = torch.as_tensor(rng.randn(L, n, kk).astype(np.float32))
    monkeypatch.setattr(ot, "_LEAF_ONEHOT_ELEMS", L * n_leaves * rows)
    got = ot._leaf_sums(leaf, SC, n_leaves, exact=False)
    want = torch.zeros((L, n_leaves, kk))
    for r0 in range(0, n, rows):
        oh = torch.nn.functional.one_hot(leaf[:, r0:r0 + rows], n_leaves).float()
        want += torch.bmm(oh.transpose(1, 2), SC[:, r0:r0 + rows])
    assert torch.equal(got, want)
    exact = np.zeros((L, n_leaves, kk))
    for lane in range(L):
        np.add.at(exact[lane], leaf[lane].numpy(), SC[lane].double().numpy())
    assert np.abs(got.double().numpy() - exact).max() < 1e-5 * np.abs(exact).max()
    counts = torch.as_tensor(rng.randint(0, 3, (L, n, kk)).astype(np.float32))
    assert torch.equal(ot._leaf_sums(leaf, counts, n_leaves, exact=True),
                       torch.zeros((L, n_leaves, kk)).scatter_add_(
                           1, leaf[..., None].expand(-1, -1, kk), counts))


def test_float_stat_trees_price_a_lane_of_the_f32_scratch():
    """A regression forest's and boosting's memory estimate carry a lane's
    share of B4's f32 scratch (``f32_lane_bytes``: ~58 MB a lane on
    covertype), a classification forest's (int32 stats) does not."""
    from cs230_distributed_machine_learning_tpu_torch.models import trees as mt

    n, d = 116_202, 54
    static = {"_n_bins": 128, "_depth": 3, "_n_classes": 2}
    lane_mb = H.f32_lane_bytes(n, d, 128) / 1e6
    assert 40 < lane_mb < 80
    rfr = mt.RandomForestRegressorKernel().memory_estimate_mb(n, d, static)
    rfc = mt.RandomForestClassifierKernel().memory_estimate_mb(n, d, static)
    assert rfr - rfc == pytest.approx(lane_mb)
    gb = mt.GradientBoostingClassifierKernel().memory_estimate_mb(n, d, static)
    assert gb == pytest.approx(rfr + 64.0 * n / 1e6)
