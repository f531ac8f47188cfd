"""B1's fused wide form's plan and route rule (ops/cuda_logreg.py::
fused_plan, route_plan), and the port's packed gradient at the shapes that
take it against the JAX package's packed softmax-gradient kernel.

Where B1 / B2 have no register-resident geometry, ``packed_softmax_grad``
runs on the card the fused kernel (one pass, the bf16 residual in shared
memory, the gradient in registers; one CTA a lane block, or a cluster of
2 or 4 CTAs a lane past a CTA's classes) where ``fused_plan`` has a
geometry, to 256 classes, else the two passes (``wide_plan``). On the CPU
the wrapper computes the plain version, held here against the JAX
package's Pallas kernel in interpret mode and its XLA reference on the
same numpy inputs at the fused form's shapes, within 5e-3 of the max
(tests/test_pallas_logreg.py's bf16 Gram tolerance). The kernel itself is
held against the plain version on the card, and the plan against the
library's, by tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.ops import pallas_logreg as jx
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as tk

TOL = 5e-3

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)

_packed_grad_ref = jax.jit(jx.packed_softmax_grad_reference, static_argnames=("c", "S"))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def _inputs(n_pad, dpp, c, S, n_wb, seed):
    """The packed kernels' inputs as numpy, then as JAX and torch arrays
    holding the same bf16 values: rows, weights (zero past the last real
    feature, as the packed path pads them), labels, split weights."""
    rng = np.random.RandomState(seed)
    A = rng.randn(n_pad, dpp).astype(np.float32)
    W = (rng.randn(n_wb, dpp, c * S * tk.TRIAL_BLOCK) * 0.1).astype(np.float32)
    A[:, dpp - 3:] = 0.0
    W[:, dpp - 3:] = 0.0
    A_j, W_j = jnp.asarray(A).astype(jnp.bfloat16), jnp.asarray(W).astype(jnp.bfloat16)
    y2 = rng.randint(0, c, (n_pad, 1)).astype(np.int32)
    WSP = (rng.rand(n_pad, S) > 0.3).astype(np.float32)
    t = (torch.as_tensor(np.array(A_j.astype(jnp.float32))).to(torch.bfloat16),
         torch.as_tensor(np.array(W_j.astype(jnp.float32))).to(torch.bfloat16),
         torch.as_tensor(y2), torch.as_tensor(WSP))
    return (A_j, W_j, jnp.asarray(y2), jnp.asarray(WSP)), t


# (n_pad, dpp, classes, splits, blocks): the pitch (lanes a CTA, CTAs a
# lane) each takes
_SHAPES = {
    "c10_dpp192": (512, 192, 10, 2, 1),   # pitch 10 (8 lanes), three atoms
    "c17_dpp128": (512, 128, 17, 2, 1),   # pitch 32 (2 lanes): past 16 classes
    "c50_dpp64": (256, 64, 50, 1, 1),     # pitch 64 (one lane), one atom
    "c100_dpp320": (256, 320, 100, 1, 1),  # pitch 112, chip_smoke's probe_c100 width
    "c150_dpp448": (256, 448, 150, 1, 1),  # pitch 160: two CTAs a lane
    "c200_dpp320": (256, 320, 200, 1, 1),  # pitch 224, chip_smoke's probe_c200 width
}


@pytest.mark.parametrize("tag", sorted(_SHAPES))
def test_fused_shapes_match_the_jax_kernel(tag):
    """At shapes the fused form takes on the card, the port's packed
    gradient (its plain version on the CPU) against the JAX package's
    packed kernel (interpret mode, at the narrow shapes) and its reference
    on the same inputs."""
    n_pad, dpp, c, S, n_wb = _SHAPES[tag]
    assert tk.route_plan(n_pad, dpp, c, S, n_wb)[0] == "fused"
    j_in, t_in = _inputs(n_pad, dpp, c, S, n_wb, seed=n_pad + c)
    got = tk.packed_softmax_grad(*t_in, c=c, S=S).numpy()
    ref = np.asarray(_packed_grad_ref(*j_in, c=c, S=S))
    assert got.shape == ref.shape
    assert _rel(got, ref) < TOL
    if n_pad * c * S <= 512 * 20 * 2:  # the interpret-mode kernel at the narrow shapes
        kern = jx.packed_softmax_grad(*j_in, c=c, S=S, bm=256, interpret=True)
        assert _rel(got, kern) < TOL


@pytest.mark.parametrize("shape,ranges", [
    ((1000, 448, 10, 1, 1), 4),    # 16 CTAs: the rows in four ranges
    ((10_240, 320, 200, 6, 1), 1),  # probe_c200: 1,536 CTAs, 3 ranges would save 3 %
    ((20_480, 320, 100, 6, 1), 1),  # probe_c100: 768 CTAs fill their waves
    ((130, 448, 10, 1, 1), 3),     # three row tiles: at most one range a tile
])
def test_fused_plan_row_ranges_cover_the_rows_in_order(shape, ranges):
    """The kernel's row ranges (range p: tiles p T / P .. (p + 1) T / P - 1)
    are contiguous, in order, none empty, and cover every row tile once;
    their partials follow the transposed weights in the scratch, summed in
    range order."""
    n_pad, dpp, c, S, n_wb = shape
    plan = tk.fused_plan(*shape)
    P, T = plan["ranges"], plan["row_tiles"]
    assert P == ranges
    bounds = [(p * T // P, (p + 1) * T // P) for p in range(P)]
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(b0 < b1 for b0, b1 in bounds)
    assert all(bounds[p][1] == bounds[p + 1][0] for p in range(P - 1))
    g3 = n_wb * dpp * c * S * tk.TRIAL_BLOCK * 4
    assert plan["scratch"] == plan["vt"] + (P * g3 if P > 1 else 0)


# (n_pad, dpp, classes): the body the card runs, by shape alone
_ROUTES = [
    ((2048, 448, 16), "fused", 16),     # 16 classes past the register-resident widths
    ((2048, 448, 17), "fused", 32),     # 17: the next pitch
    ((2048, 128, 16), "resident", None),
    ((2048, 128, 17), "fused", 32),     # past 16 classes at any dpp
    ((2048, 448, 10), "fused", 10),
    ((2048, 496, 10), "fused", 16),     # eight atoms: 4 lanes a CTA
    ((2048, 512, 10), "fused", 16),
    ((2048, 512, 64), "fused", 64),
    ((2048, 512, 65), "fused", 128),    # past a CTA's classes: two CTAs a lane
    ((2048, 448, 80), "fused", 80),
    ((2048, 448, 81), "fused", 128),
    ((2048, 320, 112), "fused", 112),
    ((2048, 320, 113), "fused", 128),
    ((2048, 256, 128), "fused", 128),
    ((2048, 256, 129), "fused", 160),
    ((2048, 448, 160), "fused", 160),
    ((2048, 448, 161), "fused", 256),   # four CTAs a lane
    ((2048, 320, 224), "fused", 224),
    ((2048, 320, 225), "fused", 256),
    ((2048, 512, 129), "fused", 256),
    ((2048, 64, 256), "fused", 256),    # two CTAs a lane at one atom
    ((2048, 512, 256), "fused", 256),
    ((2048, 64, 257), "two_pass", None),  # past 256 classes: the class-tiled pass (a)
    ((2048, 512, 257), "two_pass", None),
    ((2048, 528, 10), None, None),        # past the packed path's 512 features
    ((1000, 448, 10), "fused", 10),       # rows not a multiple of the tile
]


@pytest.mark.parametrize("shape,route,pitch", _ROUTES,
                         ids=[f"{n}x{d}x{c}" for (n, d, c), _, _ in _ROUTES])
def test_wide_route_at_its_boundaries(shape, route, pitch):
    """Each shape takes the body its geometry allows, never another: the
    fused form's least pitch that holds the classes, to 256 classes; the
    two passes past them (the class-tiled pass (a)); nothing past dpp
    512."""
    n_pad, dpp, c = shape
    S, n_wb = 6, 1
    assert tk.route_plan(n_pad, dpp, c, S, n_wb)[0] == route
    plan = tk.fused_plan(n_pad, dpp, c, S, n_wb)
    if route == "fused":
        assert plan["pitch"] == pitch
    elif route != "resident":
        assert plan is None
    if route == "two_pass":
        assert tk.wide_plan(n_pad, dpp, c, S, n_wb)["cpp"] == tk.class_pitch(c)
        assert (tk.class_pitch(c) > tk.CLASS_TILE) == (c > tk.CLASS_TILE)


@pytest.mark.parametrize("shape", [
    (20_480, 448, 10, 6, 2), (20_480, 320, 100, 6, 1), (4096, 448, 10, 6, 1),
    (2000, 64, 20, 3, 1), (1000, 512, 3, 2, 2), (700, 496, 16, 2, 1), (900, 192, 50, 2, 1),
    (800, 384, 70, 1, 1), (600, 256, 128, 1, 1), (64, 16, 2, 1, 1), (116_736, 512, 64, 6, 8),
    (10_240, 320, 200, 6, 1), (600, 256, 129, 1, 1), (700, 512, 256, 1, 1),
    (1000, 448, 161, 1, 1), (2048, 64, 256, 6, 1),
])
def test_fused_plan_fits_the_card(shape):
    """Every fused plan holds its classes, fits a CTA's shared memory with
    at least two ring sets and its registers (the logits and a warpgroup's
    share of the gradient over every atom), covers each lane once (a
    cluster's CTAs its class quarters), takes a cluster only where one CTA
    cannot hold the lane's classes, and splits the rows only where that
    shortens the waves of CTAs by over a tenth and the partials fit the
    scratch cap; its scratch holds the transposed weights (every lane's
    padded classes and features, bf16) and the partials; its fields are the
    library's, in order."""
    n_pad, dpp, c, S, n_wb = shape
    plan = tk.fused_plan(*shape)
    assert tuple(plan) == tk.FUSED_PLAN_FIELDS
    assert (plan["nc"], plan["L"], plan["ku"], plan["cl"]) in tk.FUSED_GEOMETRIES
    assert plan["pitch"] == 2 * plan["nc"] * plan["cl"] // plan["L"] >= c
    one_cta = [g for g in tk.FUSED_GEOMETRIES if g[3] == 1 and 2 * g[0] // g[1] >= c
               and g[2] >= plan["mt"] and tk.TRIAL_BLOCK % g[1] == 0]
    assert (plan["cl"] == 1) == bool(one_cta)
    assert plan["cl"] == 1 or plan["L"] == 1
    assert plan["mt"] == -(-dpp // 64) <= plan["ku"]
    assert plan["nc"] // 2 * (plan["ku"] + 1) <= 168
    assert 2 <= plan["stages"] <= 4 and plan["smem"] <= tk.SMEM_LIMIT
    assert plan["smem"] == tk.fused_layout(plan["nc"], plan["mt"], plan["stages"])
    assert plan["blocks"] * plan["L"] == n_wb * S * tk.TRIAL_BLOCK * plan["cl"]
    assert plan["row_tiles"] == -(-n_pad // tk.FUSED_ROWS) >= plan["ranges"]
    g3 = n_wb * dpp * c * S * tk.TRIAL_BLOCK * 4
    time = {P: -(-plan["blocks"] * P // 132) / P for P in range(1, min(4, plan["row_tiles"]) + 1)
            if P == 1 or P * g3 <= tk.WIDE_SCRATCH_BYTES}
    P = plan["ranges"]
    assert all(time[Q] < 0.9 * time[Q_prev] for Q, Q_prev in [(P, 1)] if P > 1)
    assert all(time[Q] >= 0.9 * time[P] for Q in time if Q > P)  # no later range count pays
    assert plan["vt"] == -(-n_wb * S * tk.TRIAL_BLOCK * plan["pitch"] * plan["mt"] * 128
                           // 1024) * 1024
    assert plan["scratch"] == plan["vt"] + (P * g3 if P > 1 else 0)
    assert plan["scratch"] - plan["vt"] <= tk.WIDE_SCRATCH_BYTES
    if tk.route_plan(*shape)[0] == "fused":  # (a register-resident shape holds no scratch)
        assert tk.wide_scratch_bytes(*shape) == plan["scratch"]


def test_fused_plan_refuses_what_the_kernel_does_not_take():
    """None off the 16-feature grid, below two classes, for a trial block
    its lanes do not tile, and past 256 classes (the two passes' then)."""
    assert tk.fused_plan(2048, 72, 10, 6, 1) is None
    assert tk.fused_plan(2048, 64, 1, 6, 1) is None
    assert tk.fused_plan(2048, 64, 10, 6, 1, Tw=8) is None
    assert tk.fused_plan(2048, 512, 300, 6, 1) is None
    assert tk.wide_plan(2048, 512, 300, 6, 1) is not None
    assert tk.wide_scratch_bytes(2048, 512, 300, 6, 1) == tk.wide_plan(2048, 512, 300, 6, 1)[
        "scratch"]
    assert tk.wide_scratch_bytes(116_736, 64, 7, 6, 8) == 0  # the register-resident body
