"""The PyTorch port's LogReg kernels (ops/cuda_logreg.py) against the JAX
package's Pallas kernels.

On the CPU the wrappers compute their plain PyTorch versions; those are
held against the Pallas kernels in interpret mode and against the JAX
``*_reference`` functions on the same numpy inputs, at the JAX tests'
shapes. Tolerance: 5e-3 of the max, the bf16 Gram tolerance of
tests/test_pallas_logreg.py (the kernels round the residual to bf16, the
plain versions keep it in f32). Frozen columns of the fused step must be
exact.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_gpu.py.
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

# the JAX references, compiled whole (op by op they take most of the run)
_packed_grad_ref = jax.jit(jx.packed_softmax_grad_reference, static_argnames=("c", "S"))
_step_ref = jax.jit(jx.packed_nesterov_step_reference, static_argnames=("c", "S", "lam"))
_masked_ref = jax.jit(jx.masked_softmax_grad_reference, static_argnames=("c",))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def _bf16(rng_arr):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(rng_arr).astype(jnp.bfloat16)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _packed_grad_inputs(c=4, S=3, n_pad=512, dpp=64, n_wb=2, seed=0):
    rng = np.random.RandomState(seed)
    NB = c * S * 128
    Ab_j, Ab_t = _bf16(rng.randn(n_pad, dpp).astype(np.float32))
    W_j, W_t = _bf16((rng.randn(n_wb, dpp, NB) * 0.2).astype(np.float32))
    y2 = rng.randint(0, c, (n_pad, 1)).astype(np.int32)
    WSP = (rng.rand(n_pad, S) > 0.3).astype(np.float32)
    return (Ab_j, W_j, jnp.asarray(y2), jnp.asarray(WSP)), (
        Ab_t, W_t, torch.as_tensor(y2), torch.as_tensor(WSP)
    )


def test_packed_softmax_grad_plain_matches_pallas():
    c, S = 4, 3
    j_in, t_in = _packed_grad_inputs(c, S)
    got = tk.packed_softmax_grad(*t_in, c=c, S=S).numpy()
    kern = jx.packed_softmax_grad(*j_in, c=c, S=S, bm=256, interpret=True)
    ref = _packed_grad_ref(*j_in, c=c, S=S)
    assert _rel(got, kern) < TOL
    assert _rel(got, ref) < 1e-4  # same f32 algebra as the JAX reference


def _fused_step_inputs(c, S, n_wb=2, n_pad=512, dpp=64, seed=0):
    """The JAX test's inputs (tests/test_pallas_logreg.py), as numpy."""
    rng = np.random.RandomState(seed)
    B = S * 128
    NB = c * B
    Ab = rng.randn(n_pad, dpp).astype(np.float32)
    W = (rng.randn(n_wb, dpp, NB) * 0.2).astype(np.float32)
    Wp = (rng.randn(n_wb, dpp, NB) * 0.2).astype(np.float32)
    y2 = rng.randint(0, c, (n_pad, 1)).astype(np.int32)
    WSP = (rng.rand(n_pad, S) > 0.3).astype(np.float32)
    done = (rng.rand(n_wb, B) > 0.7).astype(np.float32)
    step = (0.01 + rng.rand(n_wb, B) * 0.1).astype(np.float32)
    Cb = (0.1 + rng.rand(n_wb, B)).astype(np.float32)
    maxit = np.where(rng.rand(n_wb, B) > 0.5, 100.0, 2.0).astype(np.float32)
    pen = np.ones((dpp, 1), np.float32)
    pen[-10:] = 0.0
    return [Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen]


def _split_args(arrs):
    """numpy args -> (jax args, torch args) with Ab as matching bf16."""
    Ab_j, Ab_t = _bf16(arrs[0])
    j = [Ab_j] + [jnp.asarray(a) for a in arrs[1:]]
    t = [Ab_t] + [torch.as_tensor(a.copy()) for a in arrs[1:]]
    return j, t


@pytest.mark.parametrize("c,S,lam", [(2, 3, 2.0), (7, 3, 1.0), (3, 2, 0.0)])
def test_packed_nesterov_step_plain_matches_pallas(c, S, lam):
    arrs = _fused_step_inputs(c, S)
    j, t = _split_args(arrs)
    jargs = j[:5] + [3.0] + j[5:]
    targs = t[:5] + [3.0] + t[5:]
    kern = jx.packed_nesterov_step(*jargs, c=c, S=S, bm=256, lam=lam, interpret=True)
    ref = _step_ref(*jargs, c=c, S=S, lam=lam)
    got = tk.packed_nesterov_step(*targs, c=c, S=S, lam=lam)
    for name, g, k, r in zip(("W_new", "Wp_new", "gmax"), got, kern, ref):
        assert _rel(g.numpy(), k) < TOL, name
        assert _rel(g.numpy(), r) < 1e-4, name
    # the update lands in the caller's W / Wp tensors, as on the card
    assert got[0] is targs[1] and got[1] is targs[2]


def test_packed_nesterov_step_freezes_done_and_past_max_iter_columns():
    c, S = 3, 2
    arrs = _fused_step_inputs(c, S)
    B = S * 128
    done = np.zeros((2, B), np.float32)
    done[:, ::3] = 1.0
    maxit = np.full((2, B), 100.0, np.float32)
    maxit[:, 1::3] = 5.0
    arrs[5], arrs[8] = done, maxit
    _, t = _split_args(arrs)
    W0, Wp0 = arrs[1], arrs[2]
    W_new, Wp_new, _ = tk.packed_nesterov_step(
        *t[:5], 5.0, *t[5:], c=c, S=S, lam=1.0
    )
    frozen = np.zeros(B, bool)
    frozen[::3] = True
    frozen[1::3] = True
    cols = np.tile(frozen, c)
    np.testing.assert_array_equal(W_new.numpy()[:, :, cols], W0[:, :, cols])
    np.testing.assert_array_equal(Wp_new.numpy()[:, :, cols], Wp0[:, :, cols])
    assert np.abs(W_new.numpy()[:, :, ~cols] - W0[:, :, ~cols]).max() > 0


# (n_pad, dpp, c, cp, bm): two of the JAX test's shapes, 7-class and binary
_MASKED_SHAPES = [
    (512, 128, 7, 128, 256),
    (256, 128, 2, 128, 128),
]
# The wrapper (its plain version on the CPU) at each shape, and with a lane
# whose fold mask is all zero.
_MASKED_CASES = [pytest.param(s, False, id=str(s)) for s in _MASKED_SHAPES] + [
    pytest.param((512, 128, 7, 128, 256), True, id="(512, 128, 7, 128, 256)-zero_lane"),
]


@pytest.mark.parametrize("shape,zero_lane", _MASKED_CASES)
def test_masked_softmax_grad_plain_matches_pallas(shape, zero_lane):
    """A lane batch of 3 through the port vs the JAX lane kernel lane by
    lane, each lane with its own fold mask over the shared A; a lane whose
    mask is all zero gets a gradient of exact zeros. The card kernel's pass
    (b) adds the plan's row ranges in order: they cover the rows once."""
    n_pad, dpp, c, cp, bm = shape
    lanes = 3
    rng = np.random.RandomState(0)
    Ab_j, Ab_t = _bf16(rng.randn(n_pad, dpp).astype(np.float32))
    W = (rng.randn(lanes, dpp, cp) * 0.3).astype(np.float32)
    W[:, :, c:] = 0.0
    W_j, W_t = _bf16(W)
    y2 = rng.randint(0, c, (n_pad, 1)).astype(np.int32)
    wm = (rng.rand(n_pad, lanes) > 0.3).astype(np.float32)
    if zero_lane:
        wm[:, 1] = 0.0
    args = (Ab_t, W_t, torch.as_tensor(y2), torch.as_tensor(wm))
    got = tk.masked_softmax_grad(*args, c=c)
    ranges = tk.masked_ranges(tk.masked_plan(n_pad, dpp, cp, lanes), n_pad)
    assert len(ranges) > 1  # the split sum runs
    assert [r for rg in ranges for r in range(*rg)] == list(range(n_pad))
    assert got.shape == (lanes, dpp, cp)
    for lane in range(lanes):
        if zero_lane and lane == 1:
            assert not np.any(got[lane].numpy())
            continue
        args = (Ab_j, W_j[lane], jnp.asarray(y2), jnp.asarray(wm[:, lane : lane + 1]))
        kern = jx.masked_softmax_grad(*args, c=c, bm=bm, interpret=True)
        ref = _masked_ref(*args, c=c)
        assert _rel(got[lane].numpy(), kern) < TOL
        assert _rel(got[lane].numpy(), ref) < 1e-4
    np.testing.assert_array_equal(got[:, :, c:].numpy(), 0.0)


def test_pack_unpack_weights_round_trip_and_jax_layout():
    """pack_weights puts lane (trial t, split s) weight [k, a] at packed
    column (a*S + s)*Tw + t of block t // Tw — the JAX packed layout."""
    rng = np.random.RandomState(4)
    chunk, S, dp, c, dpp = 256, 3, 6, 4, 64
    W = torch.as_tensor(rng.randn(chunk, S, dp, c).astype(np.float32))
    W3 = tk.pack_weights(W, dpp)
    assert W3.shape == (2, dpp, c * S * 128)
    t, s, k, a = 130, 2, 5, 3
    assert W3[1, k, (a * S + s) * 128 + (t - 128)] == W[t, s, k, a]
    assert float(W3[:, dp:].abs().max()) == 0.0
    torch.testing.assert_close(tk.unpack_weights(W3, S, dp, c), W, rtol=0, atol=0)
    params = rng.randn(dp, c).astype(np.float32)
    np.testing.assert_array_equal(tk.weights_from_jax(params).numpy(), params)


def test_gates_and_shared_memory_plan():
    # covertype: dpp = 64, c = 7 -> B1's 16-lane tile
    assert tk.fused_step_applicable(64, 7)
    assert tk.step_geometry(64, 7)["L"] == 16
    # binary: 16 lanes of 2 classes, 32 columns a CTA
    geo = tk.step_geometry(64, 2)
    assert (geo["L"], geo["n1"]) == (16, 32)
    assert _packed_smem_bytes(64, 7, 16) <= tk.SMEM_LIMIT
    # no register-resident geometry (too many gradient floats a thread) ->
    # the packed path's body is B1's wide form
    assert not tk.fused_step_applicable(512, 7)
    assert tk.wide_plan(2048, 512, 7, 6, 1) is not None
    # 784-feature LogReg lane kernel: dpp 896, 10 classes padded to 16;
    # features are tiled, so 2,048 of them pass too; and classes past 256
    # (the class-tiled pass (a))
    assert tk.masked_grad_applicable(896, 16)
    assert tk.masked_grad_applicable(2048, 16)
    assert tk.masked_grad_applicable(896, 272)
    assert not tk.masked_grad_applicable(896, 24)
    assert not tk.masked_grad_applicable(904, 16)


def _wmma_masked_gate(dpp, cp):
    """The masked gate as it stood before B3's two-pass design (one lane's
    gradient in a CTA's WMMA registers, its buffers in shared memory),
    restated from its rule."""
    def ld_f32(cols):
        return cols + (40 - cols % 32) % 32

    def align(x):
        return (x + 127) // 128 * 128

    off = align(dpp * (cp + 8) * 2)  # the lane's weights
    for _ in range(2):
        off = align(off + 32 * (dpp + 8) * 2)  # 32-row tiles of A
    off = align(off + 8 * 32 * ld_f32(cp) * 4)  # per-warp partial logits
    off = align(off + 32 * ld_f32(cp) * 4)  # logits
    off = align(off + 32 * (cp + 8) * 2)  # residual
    for _ in range(4):
        off = align(off + 32 * 4)  # labels, weights
    return (dpp % 16 == 0 and cp % 16 == 0 and (dpp // 16) * (cp // 16) <= 64
            and off <= tk.SMEM_LIMIT)


def test_masked_gate_still_accepts_every_shape_it_accepted():
    """Every (dpp, cp) the WMMA lane kernel took still reaches the kernel;
    the dpp cap is gone."""
    grid = [(dpp, cp) for dpp in range(16, 4097, 16) for cp in range(16, 1025, 16)]
    before = [sh for sh in grid if _wmma_masked_gate(*sh)]
    assert len(before) == 179 and (896, 16) in before and (1024, 16) in before
    assert all(tk.masked_grad_applicable(*sh) for sh in before)
    assert tk.masked_grad_applicable(1152, 16) and tk.masked_grad_applicable(4096, 16)


@pytest.mark.parametrize("n_pad,lanes", [(256, 1), (4096, 16), (60_160, 192), (1000, 7)])
def test_masked_plan_fits_and_covers_the_rows(n_pad, lanes):
    """B3's plan at every shape the gate accepts (dpp to 2,048, cp to 544):
    both passes' shared memory within a CTA's, an instantiated pass (a)
    (past 256 classes a cluster's class slices, their weights resident or,
    where a slice's weights do not fit, streamed with A),
    whole lanes in its column tile, the P row ranges covering [0, n_pad)
    once in order, and the scratch the sum of W^T, R^T and the
    partials."""
    for dpp in range(16, 2049, 16):
        for cp in range(16, 545, 16):
            assert tk.masked_grad_applicable(dpp, cp)
            plan = tk.masked_plan(n_pad, dpp, cp, lanes)
            assert plan["smem_a"] <= tk.SMEM_LIMIT and plan["smem_b"] <= tk.SMEM_LIMIT
            assert plan["stages_a"] >= 1 and plan["stages_b"] >= 1
            assert plan["cpp"] == tk.class_pitch(cp) >= cp
            if plan["cpp"] <= tk.CLASS_TILE:
                assert (plan["na"], plan["cpp"]) in tk.MASKED_GEOMETRIES
                assert plan["na"] % plan["cpp"] == 0 and plan["cols"] % plan["na"] == 0
            else:
                assert plan["pass_a"] == ("cluster_ring" if plan["ring_w"] else "cluster")
                assert plan["na"] in tk.CLUSTER_SLICES and plan["na"] * plan["cl"] == plan["cpp"]
                assert 1 <= plan["ranges_a"] <= 2 * plan["row_tiles"]
            assert plan["cols"] >= lanes * plan["cpp"]
            assert plan["mt"] * 64 >= dpp and 2 * plan["fb"] >= plan["mt"]
            ranges = tk.masked_ranges(plan, n_pad)
            assert len(ranges) == plan["ranges"] <= min(16, plan["row_tiles"])
            assert ranges[0][0] == 0 and ranges[-1][1] == n_pad
            assert all(r0 < r1 for r0, r1 in ranges)
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            rows_pad = plan["row_tiles"] * 128
            wt = plan["cols"] * dpp * 2
            r = plan["cols"] * rows_pad * 2
            part = plan["ranges"] * dpp * plan["cols"] * 4
            assert plan["r_offset"] >= wt and plan["part_offset"] - plan["r_offset"] >= r
            assert plan["scratch"] == plan["part_offset"] + part
            assert plan["r_offset"] % 1024 == 0 and plan["part_offset"] % 1024 == 0
    wide = tk.masked_plan(n_pad, 896, 272, lanes)  # two CTAs of 160, W^T streamed
    assert (wide["cpp"], wide["na"], wide["pass_a"]) == (320, 160, "cluster_ring")
    assert wide["smem_a"] <= tk.SMEM_LIMIT
    assert tk.masked_plan(n_pad, 904, 16, lanes) is None


def _packed_smem_bytes(dpp, c, L):
    """Shared memory of one CTA of the first (mma.sync) packed kernels at
    a lane tile of L lanes, restated from their layout."""
    def align(x):
        return (x + 127) // 128 * 128

    CL, ld = c * L, c * L + (40 - c * L % 32) % 32
    off = align(CL * (dpp + 8) * 2)                 # bf16 V^T
    for _ in range(2):
        off = align(off + 64 * (dpp + 8) * 2)       # bf16 A tiles
    off = align(off + CL * (64 + 8) * 2)            # bf16 residual
    for _ in range(4):
        off = align(off + 64 * 4)                   # labels, split weights
    off = max(off, align(dpp * ld * 4))             # gradient staging overlay
    return align(off + 256 * 4)                     # max|G| partials


def _mma_sync_gate(dpp, c):
    """The packed gate as it stood before B2's wgmma design (a 16- or
    32-lane tile of the mma.sync kernels, B1 and the first B2, fits),
    restated from its rule."""
    return any(
        dpp % 16 == 0 and c <= 16 and (dpp // 8) * (c * L // 16) <= 128
        and _packed_smem_bytes(dpp, c, L) <= tk.SMEM_LIMIT
        for L in (32, 16))


def test_packed_gate_still_accepts_every_shape_it_accepted():
    """No search that took the fused step leaves it: every (dpp, c) the
    mma.sync kernels took still passes fused_step_applicable (a B1 / B2
    register-resident geometry exists). The rule now: the fused step
    wherever step_geometry has a geometry, and every other shape of the
    packed path (dpp <= 512, any classes) has a plan for B1's wide form."""
    grid = [(dpp, c) for dpp in range(16, 1025, 16) for c in range(2, 40)]
    before = [sh for sh in grid if _mma_sync_gate(*sh)]
    assert len(before) == 147 and (64, 7) in before and (512, 2) in before
    fused = [sh for sh in grid if tk.fused_step_applicable(*sh)]
    assert set(before) <= set(fused)
    assert fused == [sh for sh in grid if tk.step_geometry(*sh) is not None]
    # the C5 cells B2 now takes: (128, 9-16), (192, 6-8), (320, 4), (384, 3-4)
    assert {(128, 9), (128, 16), (192, 6), (192, 8), (320, 4), (384, 3), (384, 4)} <= set(fused)
    assert all(max(c for d, c in fused if d == dpp) <= 16 for dpp, _ in fused)
    for dpp, c in grid:
        if dpp <= tk.WIDE_MAX_DPP and (dpp, c) not in fused:
            assert tk.wide_plan(2048, dpp, c, 6, 1) is not None, (dpp, c)


def test_fused_step_geometry_fits_registers_and_shared_memory():
    """B2's geometry at every accepted shape: an instantiated (N1, L, MT),
    N1 = L x (c rounded up to a power of two) <= 128 with L a multiple of
    8 (a thread then holds every class of its lanes), the logits and a
    whole gradient within 192 floats a thread, at least one ring stage, and
    the layout within a CTA's shared memory; every instantiation is used.
    At covertype's shape: 16 lanes, 128 columns, one feature atom, four
    stages of 128 rows."""
    used = set()
    for dpp in range(16, 1025, 16):
        for c in range(2, 40):
            if not tk.fused_step_applicable(dpp, c):
                continue
            geo = tk.step_geometry(dpp, c)
            key = (geo["n1"], geo["L"], geo["mt"])
            used.add(key)
            assert key in tk.STEP_GEOMETRIES
            assert geo["L"] % 8 == 0 and geo["n1"] % geo["L"] == 0
            maxc = geo["n1"] // geo["L"]
            assert maxc >= c and maxc & (maxc - 1) == 0 and geo["n1"] <= 128
            assert geo["mt"] * 64 >= dpp > (geo["mt"] - 1) * 64
            assert geo["n1"] // 2 * (geo["mt"] + 1) <= 192
            assert 1 <= geo["stages"] <= 4 and geo["total"] <= tk.SMEM_LIMIT
    assert used == set(tk.STEP_GEOMETRIES)
    geo = tk.step_geometry(64, 7)
    assert (geo["L"], geo["n1"], geo["mt"], geo["stages"]) == (16, 128, 1, 4)
    assert geo["total"] == 153_728 == tk.step_layout(64, 128)["total"]
    assert tk.step_geometry(512, 2)["stages"] == 1  # eight atoms: one 132 KB stage
    assert tk.step_geometry(64, 16)["L"] == 8  # 16 classes: 8 lanes, 128 columns
    assert tk.step_geometry(64, 17) is None and tk.step_geometry(72, 7) is None


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    c, S = 4, 3
    _, t_in = _packed_grad_inputs(c, S, n_wb=1)
    tk.reset_launches()
    G = tk.packed_softmax_grad(*t_in, c=c, S=S)
    ref = tk.packed_softmax_grad_reference(*t_in, c=c, S=S)
    torch.testing.assert_close(G, ref, rtol=0, atol=0)
    assert tk.LAUNCHES == {k: 0 for k in tk.LAUNCHES}  # no kernel launched
