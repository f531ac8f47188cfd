"""B3's pass (a) past 256 classes (ops/cuda_logreg.py): the plan of its
clusters, the class pitch it pads to, and the port's masked gradient there
against the JAX package's.

Past 256 classes a lane's classes do not fit one CTA's accumulator. To
2,048 classes a cluster of k = ceil(cp / 256) CTAs owns a lane, each a
slice of N columns (a multiple of 32 in (128, 256]), so the pitch is k x N
(320 at 300 classes, where it was 512), each CTA's slice of the weights
resident in shared memory, or streamed through the ring with A where it
does not fit there (many features); past 2,048 classes the two sweeps of
256-class tiles run at a pitch that is a multiple of 256.
The plans here are pure shape arithmetic, held against the library's
(csrc/logreg.cu) on the card by tests/test_torch_kernels_gpu.py, as is
the kernel against its plain version. On the CPU the wrapper computes the
plain version, held against the JAX package's reference within 1e-4 of
the max (both f32, summed in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.ops import pallas_logreg as jx
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as tk
from cs230_distributed_machine_learning_tpu_torch.ops import kernel_cases as kc

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)

_masked_ref = jax.jit(jx.masked_softmax_grad_reference, static_argnames=("c",))

# cp: (pitch, CTAs a cluster, a CTA's slice) at dpp 128, or the sweeps
_BOUNDARIES = dict(zip(kc.CLASS_BOUNDARIES, [
    (320, 2, 160, "cluster"),
    (320, 2, 160, "cluster"),
    (320, 2, 160, "cluster"),
    (384, 2, 192, "cluster"),
    (512, 2, 256, "cluster"),
    (576, 3, 192, "cluster"),
    (1024, 4, 256, "cluster"),
    (2048, 8, 256, "cluster"),
    (2304, 1, 256, "sweeps"),
], strict=True))


@pytest.mark.parametrize("cp", sorted(_BOUNDARIES))
def test_pitch_and_cluster_at_the_class_boundaries(cp):
    """The pitch, the cluster's CTAs and their slice at each class count
    where they change: k x N with N a multiple of 32 in (128, 256] to 2,048
    classes, then a multiple of 256 and the sweeps; the B3 and the wide
    form's plans agree."""
    pitch, cl, na, route = _BOUNDARIES[cp]
    assert tk.class_pitch(cp) == pitch
    plan = tk.masked_plan(4096, 128, cp, 3)
    assert (plan["cpp"], plan["cl"], plan["na"], plan["pass_a"]) == (pitch, cl, na, route)
    if route == "cluster":
        assert na in tk.CLUSTER_SLICES and 128 < na <= 256 and na % 32 == 0
        assert cl == -(-cp // tk.CLASS_TILE) <= tk.CLUSTER_MAX_CTAS and cl * na == pitch
    else:
        assert pitch % tk.CLASS_TILE == 0 and cp > tk.CLUSTER_MAX_CTAS * tk.CLASS_TILE
    wide = tk.wide_plan(4096, 128, cp, 2, 1)
    assert (wide["cpp"], wide["cl"], wide["na"], wide["pass_a"]) == (pitch, cl, na, route)


def test_pitch_to_256_classes_is_unchanged():
    """Up to 256 classes the pitch is the power of two from 16 it was."""
    for cp in range(16, 257, 16):
        want = 16
        while want < cp:
            want *= 2
        assert tk.class_pitch(cp) == want
        assert tk.masked_plan(4096, 128, cp, 3)["pass_a"] == "lanes"


@pytest.mark.parametrize("n_pad,dpp,cp,lanes", [
    (8192, 128, 304, 64), (2000, 80, 528, 3), (1000, 64, 2064, 5), (700, 512, 336, 7),
])
def test_lane_columns_lie_inside_the_columns_and_never_overlap(n_pad, dpp, cp, lanes):
    """Every lane's pitch of columns lies inside R's columns, no two lanes
    share one, a cluster's slices (W^T resident or streamed; or the sweeps'
    256-class tiles, clipped to the pitch, as the W^T transpose tiles it)
    cover the lane's pitch once, and the scratch holds W^T and R^T over
    every column."""
    plan = tk.masked_plan(n_pad, dpp, cp, lanes)
    cpp, cols = plan["cpp"], plan["cols"]
    owner = np.full(cols, -1)
    for lane in range(lanes):
        assert (owner[lane * cpp:(lane + 1) * cpp] == -1).all()
        owner[lane * cpp:(lane + 1) * cpp] = lane
    assert lanes * cpp <= cols and cols % 128 == 0
    width = plan["na"]
    tiles = [(a0, min(cpp, a0 + width)) for a0 in range(0, cpp, width)]
    assert tiles[0][0] == 0 and tiles[-1][1] == cpp
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    if plan["pass_a"] in ("cluster", "cluster_ring"):
        assert len(tiles) == plan["cl"] and all(b - a == width for a, b in tiles)
    assert plan["r_offset"] >= cols * dpp * 2
    assert plan["part_offset"] - plan["r_offset"] >= cols * plan["row_tiles"] * 128 * 2


@pytest.mark.parametrize("cp", [c for c in sorted(_BOUNDARIES) if c <= 2048])
def test_cluster_where_its_slice_fits_and_sweeps_elsewhere(cp):
    """At every feature count to 2,048 classes a cluster runs, of the same
    CTAs at the same pitch: its slice's W^T resident exactly where a CTA's
    shared memory holds it, one ring set of 64-row tiles, the staging tile
    and the pairs (at most 232,448 bytes, at least one set), and streamed
    with A elsewhere (a ring of 2-8 stages, each an atom's box of A and of
    W^T); the sweeps run only past 2,048 classes."""
    pitch, cl, na, _ = _BOUNDARIES[cp]
    for dpp in range(16, 1025, 16):
        mt = -(-dpp // 64)
        plan = tk.masked_plan(2048, dpp, cp, 2)
        assert (plan["cpp"], plan["cl"], plan["na"]) == (pitch, cl, na)
        fits = tk.cluster_layout(na, mt, 1) <= tk.SMEM_LIMIT
        assert plan["pass_a"] == ("cluster" if fits else "cluster_ring"), (dpp, plan)
        assert plan["ring_w"] == (not fits)
        assert plan["smem_a"] <= tk.SMEM_LIMIT and plan["stages_a"] >= 1
        assert plan["smem_a"] == tk.cluster_layout(na, mt, plan["stages_a"], plan["ring_w"])
        if fits:
            assert plan["stages_a"] == min(4, (tk.SMEM_LIMIT - tk.cluster_layout(na, mt, 0))
                                           // (mt * 64 * 128))
            assert plan["stages_a"] * mt < 128  # the full mbarriers fit their 1 KB
        else:
            free = tk.SMEM_LIMIT - tk.cluster_layout(na, mt, 0, 1)
            assert 2 <= plan["stages_a"] == min(8, free // (64 * 128 + na * 128))


@pytest.mark.parametrize("n_pad,dpp,cp,lanes,stages", [
    (8192, 512, 304, 8, 7),     # 300 classes past dpp 448: two CTAs of 160
    (2000, 768, 1008, 3, 4),    # a 1,000-class probe on 768-wide embeddings: four of 256
    (700, 320, 1008, 2, 4),     # four atoms of a 256-class slice fit; five do not
    (600, 1024, 2048, 1, 4),    # eight CTAs, 16 atoms
    (4096, 2048, 528, 5, 6),    # three CTAs of 192, 32 atoms
])
def test_streamed_weights_ring_holds_whole_atoms(n_pad, dpp, cp, lanes, stages):
    """Where a slice's W^T does not stay resident, the ring's stages each
    hold one atom's 64-row box of A and the slice's box of W^T (1 KB-aligned
    for the 128-byte swizzle, its rows within a TMA box's 256), the
    stages' mbarriers fit their 1 KB, and nothing else but the staging
    tile and the pairs sits beside them."""
    plan = tk.masked_plan(n_pad, dpp, cp, lanes)
    na, mt = plan["na"], plan["mt"]
    assert (plan["pass_a"], plan["ring_w"], plan["stages_a"]) == ("cluster_ring", 1, stages)
    assert na <= 256 and (64 * 128 + na * 128) % 1024 == 0
    assert tk.cluster_layout(na, mt, 1) > tk.SMEM_LIMIT  # resident would not fit
    assert plan["smem_a"] == (1024 + na * 128 + 2 * 256 * 16 + stages * (64 * 128 + na * 128)
                              + 1024) <= tk.SMEM_LIMIT
    assert stages * 8 <= 1024


@pytest.mark.parametrize("n_pad,lanes,want", [
    (8192, 64, 1),    # probe_scored: 128 CTAs, one wave
    (2000, 3, 15),    # 6 CTAs: the rows split while a range fewer costs a tenth more
    (60_160, 192, 1),
])
def test_cluster_row_ranges_fill_the_waves(n_pad, lanes, want):
    """Pass (a)'s row ranges: from one, each count whose waves of lanes x cl
    x ranges CTAs (one an SM), a wave's time being a range's share of the
    64-row tiles, take under 0.9 of the time of the count taken so far; the
    ranges cut the tiles in order, none empty."""
    plan = tk.masked_plan(n_pad, 128, 304, lanes)
    P, T, units = plan["ranges_a"], 2 * plan["row_tiles"], lanes * plan["cl"]
    assert P == want

    def cost(q):
        return -(-units * q // 132) / q

    assert all(cost(q) >= 0.9 * cost(P) for q in range(P + 1, min(16, T) + 1))
    bounds = [(p * T // P, (p + 1) * T // P) for p in range(P)]
    assert bounds[0][0] == 0 and bounds[-1][1] == T and all(a < b for a, b in bounds)


def test_wide_plan_at_probe_c300_takes_two_launches():
    """chip_smoke.py's probe_c300 (8,192 rows, dpp 128, 300 classes, 4
    splits, one block): at a pitch of 320 the 2.68 GB residual goes in two
    launches of two lane blocks (four at 512), each launch's scratch under
    the 2 GiB cap, pass (a) in clusters of two CTAs of 160 columns."""
    plan = tk.wide_plan(8192, 128, 300, 4, 1)
    assert (plan["cpp"], plan["launches"], plan["lane_launches"], plan["lb"]) == (320, 2, 2, 2)
    assert (plan["pass_a"], plan["cl"], plan["na"], plan["ranges_a"]) == ("cluster", 2, 160, 1)
    assert plan["ring_w"] == 0
    assert plan["scratch"] <= tk.WIDE_SCRATCH_BYTES
    r_bytes = 4 * tk.TRIAL_BLOCK * 320 * 8192 * 2
    assert r_bytes == 2_684_354_560 > tk.WIDE_SCRATCH_BYTES
    assert tk.route_plan(8192, 128, 300, 4, 1)[0] == "two_pass"


def test_memory_estimates_at_300_classes_use_the_narrower_pitch():
    """The generic driver's per-lane estimate counts R^T at the pitch of
    320 columns, and the packed dispatch's bytes the two passes' scratch at
    that pitch."""
    kernel = get_kernel("LogisticRegression")
    static = {"_method": "nesterov", "_n_classes": 300, "fit_intercept": True}
    n = 8192
    assert kernel.memory_estimate_mb(n, 64, static) == pytest.approx(
        (6.0 * 4.0 * n * 300 + 2.0 * n * 320) / 1e6)
    S, n_wb, dpp, NB = 4, 1, 128, 300 * 4 * tk.TRIAL_BLOCK
    got = kernel.batched_memory_bytes(static, n, 64, 300, S, n_wb)
    plan = tk.wide_plan(8192, dpp, 300, S, n_wb)
    assert plan["cpp"] == 320
    assert got == 16 * n_wb * dpp * NB + 4 * n_wb * 2048 * NB + plan["scratch"]
    assert tk.wide_scratch_bytes(8192, dpp, 300, S, n_wb) == plan["scratch"]


@pytest.mark.parametrize("cp,c", [(304, 300), (528, 520)])
def test_masked_gradient_past_256_classes_matches_jax(cp, c):
    """B3's wrapper (its plain version on the CPU) at 300 and 520 classes
    against the JAX package's reference lane by lane on the same bf16
    inputs, a lane whose fold mask is all zero exactly 0, padded classes 0."""
    n_pad, dpp, lanes = 256, 64, 3
    rng = np.random.RandomState(cp)
    A = jnp.asarray(rng.randn(n_pad, dpp).astype(np.float32)).astype(jnp.bfloat16)
    W = (rng.randn(lanes, dpp, cp) * 0.05).astype(np.float32)
    W[:, :, c:] = 0.0
    W = jnp.asarray(W).astype(jnp.bfloat16)
    y2 = rng.randint(0, c, (n_pad, 1)).astype(np.int32)
    wm = (rng.rand(n_pad, lanes) > 0.3).astype(np.float32)
    wm[:, 1] = 0.0
    got = tk.masked_softmax_grad(
        torch.as_tensor(np.array(A.astype(jnp.float32))).to(torch.bfloat16),
        torch.as_tensor(np.array(W.astype(jnp.float32))).to(torch.bfloat16),
        torch.as_tensor(y2), torch.as_tensor(wm), c=c).numpy()
    assert got.shape == (lanes, dpp, cp)
    assert not np.any(got[1]) and not np.any(got[:, :, c:])
    for lane in (0, 2):
        ref = np.asarray(_masked_ref(A, W[lane], jnp.asarray(y2),
                                     jnp.asarray(wm[:, lane:lane + 1]), c=c))
        assert np.abs(got[lane] - ref).max() / np.abs(ref).max() < 1e-4
