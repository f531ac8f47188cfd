"""Kernel B6's plain version (ops/cuda_knn.py) against the JAX package's
fused top-k search and a numpy brute force, on the CPU, fed the same numpy
inputs.

The JAX kernel runs as its own tests run it (``interpret=True``). The
brute force is an f64 distance matrix with a stable argsort, so equal
distances come out in index order.

Tolerances: distances within rtol/atol 1e-5 (f32 rounding of the
expansion). Indices are compared as sets per row wherever the k-th and
(k+1)-th exact distances are more than 1e-5 apart, and in order wherever
all k+1 are (rows with nearer ties are counted, not compared). Where the
data makes every distance exact (duplicated rows, empty slots), the plain
version must equal the brute force to the bit, order included: the lowest
index wins a tie. The TPU kernel emits tied distances in slot order, so
against it ties are held as sets. The kernel itself runs on the card only
(tests/test_torch_kernels_gpu.py); here the wrapper must take its plain
version because the tensors lie on the CPU, and count no launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.ops.pallas_knn import knn_topk as jax_topk
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn

torch.set_num_threads(1)

TOL = 1e-5


def _brute(Q, Xt, w, k):
    """f64 distances, masked rows and empty slots as the kernels mark them,
    stable order: (d2 [nq, k + 1], idx [nq, k + 1]) — one extra column for
    the tie check."""
    D = ((Q[:, None, :].astype(np.float64) - Xt[None, :, :]) ** 2).sum(-1)
    D[:, w <= 0] = np.inf
    idx = np.argsort(D, axis=1, kind="stable")[:, :k + 1]
    d2 = np.take_along_axis(D, idx, 1)
    pad = k + 1 - idx.shape[1]
    if pad > 0:
        idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        d2 = np.pad(d2, ((0, 0), (0, pad)), constant_values=np.inf)
    idx = np.where(np.isinf(d2), -1, idx)
    return d2, idx


def _plain(Q, Xt, W, k):
    d2, idx = cuda_knn.knn_topk_reference(torch.as_tensor(Q), torch.as_tensor(Xt),
                                          torch.as_tensor(W), k)
    return d2.numpy(), idx.numpy()


def _assert_matches_brute(d2, idx, bd2, bidx, k):
    """One lane's [nq, k] output against the brute force."""
    finite = np.isfinite(bd2[:, :k])
    np.testing.assert_array_equal(d2[~finite], np.float32(cuda_knn.INF))
    np.testing.assert_array_equal(idx[~finite], -1)
    np.testing.assert_allclose(d2[finite], bd2[:, :k][finite], rtol=TOL, atol=TOL)
    gaps = np.diff(bd2, axis=1)  # inf - inf is nan: an empty tail is untied
    gaps = np.where(np.isnan(gaps), np.inf, gaps)
    clear = gaps[:, k - 1] > TOL
    ordered = (gaps > TOL).all(axis=1)
    np.testing.assert_array_equal(np.sort(idx[clear], 1), np.sort(bidx[clear, :k], 1))
    np.testing.assert_array_equal(idx[ordered], bidx[ordered, :k])
    return int((~clear).sum())


def _assert_matches_jax(d2, idx, jd2, jidx):
    """One lane against the TPU kernel: distances within tolerance, the
    index sets equal (its ties come out in slot order)."""
    np.testing.assert_allclose(d2, jd2, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(np.sort(idx, 1), np.sort(jidx, 1))


def _jax(Q, Xt, w, k):
    d2, idx = jax_topk(jnp.asarray(Q), jnp.asarray(Xt), jnp.asarray(w), k, interpret=True)
    return np.asarray(d2), np.asarray(idx)


# (nq, n, d, k, mask): the cases of tests/test_pallas_knn.py, then k = 25
CASES = {
    "every_third_masked": (50, 300, 8, 5, "third"),
    "seven_valid_rows": (10, 100, 4, 5, "seven"),
    "across_tile_edges": (257, 2049, 6, 3, "all"),
    "k25": (40, 700, 5, 25, "third"),
    "k300_device_lists": (20, 700, 5, 300, "third"),  # above SHARED_LISTS_MAX_K
}


def _case(nq, n, d, mask, seed):
    rng = np.random.RandomState(seed)
    Q = rng.randn(nq, d).astype(np.float32)
    Xt = rng.randn(n, d).astype(np.float32)
    w = np.ones(n, np.float32)
    if mask == "third":
        w[::3] = 0
    elif mask == "seven":
        w[:] = 0
        w[:7] = 1.0
    return Q, Xt, w


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_and_brute_force(name):
    nq, n, d, k, mask = CASES[name]
    Q, Xt, w = _case(nq, n, d, mask, seed=len(name))
    d2, idx = _plain(Q, Xt, w[None], k)
    assert d2.shape == (1, nq, k) and idx.shape == (1, nq, k) and idx.dtype == np.int32
    assert (np.diff(d2[0], axis=1) >= 0).all()  # ascending
    unresolved = _assert_matches_brute(d2[0], idx[0], *_brute(Q, Xt, w, k), k)
    assert unresolved <= nq // 20, unresolved
    _assert_matches_jax(d2[0], idx[0], *_jax(Q, Xt, w, k))


def test_three_lanes_match_three_jax_calls():
    """The explicit lane axis: one call with 3 masks equals the JAX
    kernel called once per mask."""
    rng = np.random.RandomState(3)
    Q = rng.randn(60, 7).astype(np.float32)
    Xt = rng.randn(900, 7).astype(np.float32)
    W = (rng.rand(3, 900) > 0.4).astype(np.float32)
    W[2, 450:] = 0.0
    d2, idx = _plain(Q, Xt, W, 6)
    for lane in range(3):
        _assert_matches_jax(d2[lane], idx[lane], *_jax(Q, Xt, W[lane], 6))
        _assert_matches_brute(d2[lane], idx[lane], *_brute(Q, Xt, W[lane], 6), 6)


def test_duplicated_rows_lowest_index_first():
    """Every training row twice: each tie is exact, and the lower index
    comes first, in the brute force's stable order; against the TPU kernel
    (slot order on ties) the sets agree."""
    rng = np.random.RandomState(4)
    Q = rng.randn(30, 5).astype(np.float32)
    half = rng.randn(200, 5).astype(np.float32)
    Xt = np.concatenate([half, half])
    w = np.ones(400, np.float32)
    d2, idx = _plain(Q, Xt, w[None], 6)
    _, bidx = _brute(Q, Xt, w, 6)
    np.testing.assert_array_equal(idx[0], bidx[:, :6])
    assert (idx[0, :, 0::2] < 200).all() and (idx[0, :, 1::2] == idx[0, :, 0::2] + 200).all()
    np.testing.assert_array_equal(d2[0, :, 0::2], d2[0, :, 1::2])
    _assert_matches_jax(d2[0], idx[0], *_jax(Q, Xt, w, 6))


def test_k_above_valid_count_leaves_empty_slots():
    """A lane with fewer masked-in rows than k keeps (3.4e38, -1) in its
    last slots; integer data makes every distance exact, so the output
    equals the brute force to the bit. The TPU kernel's distances are the
    same; its final selection sort re-reads a retired slot for the empty
    ones, so there it is the filled slots' indices that must agree."""
    rng = np.random.RandomState(5)
    Q = rng.randint(-3, 4, (20, 4)).astype(np.float32)
    Xt = rng.randint(-3, 4, (50, 4)).astype(np.float32)
    W = np.zeros((2, 50), np.float32)
    W[0, [3, 17, 40]] = 1.0
    W[1, ::2] = 1.0
    d2, idx = _plain(Q, Xt, W, 8)
    assert (idx[0, :, 3:] == -1).all() and (d2[0, :, 3:] == np.float32(3.4e38)).all()
    for lane in range(2):
        bd2, bidx = _brute(Q, Xt, W[lane], 8)
        np.testing.assert_array_equal(idx[lane], bidx[:, :8])
        jd2, jidx = _jax(Q, Xt, W[lane], 8)
        np.testing.assert_array_equal(d2[lane], jd2)
        filled = idx[lane] >= 0
        np.testing.assert_array_equal(
            np.sort(np.where(filled, idx[lane], -1), 1),
            np.sort(np.where(jd2 < np.float32(3.4e38), jidx, -1), 1))


def test_plain_version_tile_size_does_not_change_the_answer():
    """The streamed merge gives the same lists whatever the tile width."""
    rng = np.random.RandomState(6)
    Q = torch.as_tensor(rng.randn(33, 9).astype(np.float32))
    Xt = torch.as_tensor(rng.randn(1000, 9).astype(np.float32))
    W = torch.as_tensor((rng.rand(2, 1000) > 0.5).astype(np.float32))
    a = cuda_knn.knn_topk_reference(Q, Xt, W, 7, tile=97)
    b = cuda_knn.knn_topk_reference(Q, Xt, W, 7, tile=4096)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(7)
    Q = torch.as_tensor(rng.randn(12, 3).astype(np.float32))
    Xt = torch.as_tensor(rng.randn(80, 3).astype(np.float32))
    W = torch.ones(2, 80)
    cuda_knn.reset_launches()
    got = cuda_knn.knn_topk(Q, Xt, W, 300)  # the plain version has no k limit
    want = cuda_knn.knn_topk_reference(Q, Xt, W, 300)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_knn.LAUNCHES["knn_topk"] == 0


@pytest.mark.parametrize("k,mode", [(1, "shared"), (256, "shared"), (257, "device"),
                                    (1000, "device")])
def test_knn_list_mode(k, mode):
    """Where the kernel keeps its lists: shared memory up to 256, device
    memory above, so no k is refused."""
    assert cuda_knn.knn_list_mode(k) == mode
    assert cuda_knn.smem_bytes(k) <= 232_448


def test_knn_list_mode_refuses_k_below_one():
    with pytest.raises(ValueError):
        cuda_knn.knn_list_mode(0)


def test_kernel_geometry_mirrors_the_source():
    """The shared-memory size the wrapper documents equals the CUDA
    source's layout (85,760 bytes of tiles, 1,024 of row masks a lane, 8
    bytes a lane, query and slot of lists), the largest k with
    shared-memory lists fits an H100 CTA at one lane, and lists in device
    memory take no shared memory."""
    assert cuda_knn.smem_bytes(5) == 89_344
    assert cuda_knn.smem_bytes(5, 6) == 107_264
    assert cuda_knn.smem_bytes(25, 6) == 168_704
    # a 32-query block: half the query chunk, distance tile and lists
    assert cuda_knn.smem_bytes(25, 6, 32) == 105_088
    assert cuda_knn.smem_bytes(cuda_knn.SHARED_LISTS_MAX_K) <= 232_448
    assert cuda_knn.smem_bytes(300, 6) == cuda_knn.smem_bytes(1000, 6) == 85_760 + 6 * 1024
    assert cuda_knn.knn_operations(6, 4096, 200_000, 54) == pytest.approx(9.338e10, rel=1e-3)
    # one lane group: the kernel's own work is the function's
    assert cuda_knn.knn_design_operations(6, 4096, 200_000, 54, 5) == \
        cuda_knn.knn_operations(6, 4096, 200_000, 54)


def test_knn_plan_at_the_search_launch():
    """knn_main's launch (6 lanes, 4,096 queries, 200,000 rows): all six
    lanes share each distance tile at k 5 and 25, and the rows are split
    so the grid fills the card with two CTAs an SM: 64-query blocks at
    k 5, 32-query blocks at k 25 (six lanes' lists of a 64-query block
    would leave room for one CTA an SM); at k 256 two lanes of a 32-query
    block fit (three groups, against six of one lane at 64); k 300 (lists
    in device memory, where the heaps set the time) takes one lane and 64
    queries a CTA: 384 CTAs, no split."""
    plan = {k: cuda_knn.knn_plan(4096, 200_000, 6, k) for k in (5, 25, 256, 300)}
    key = ("query_block", "lane_group", "lane_groups", "ranges", "ctas")
    assert tuple(plan[5][x] for x in key) == (64, 6, 1, 4, 256)
    assert tuple(plan[25][x] for x in key) == (32, 6, 1, 2, 256)
    assert tuple(plan[256][x] for x in key) == (32, 2, 3, 1, 384)
    assert tuple(plan[300][x] for x in key) == (64, 1, 6, 1, 384)


@pytest.mark.parametrize("L", [1, 2, 6, 9, 16, 17, 40])
def test_lane_group_fits_shared_memory_for_every_k(L):
    """For every k (both list modes) the plan's lane group fits a CTA's
    232,448 bytes; it is the largest up to 16 lanes that fits its query
    block (one lane with the lists in device memory), spread evenly over
    the fewest groups covering L, and the query block is the one needing
    fewer groups (64 with device-memory lists); the row ranges are
    non-empty, contiguous and cover the table."""
    for k in list(range(1, 301)) + [511, 2000]:
        plan = cuda_knn.knn_plan(4096, 200_000, L, k)
        G, groups, bq = plan["lane_group"], plan["lane_groups"], plan["query_block"]
        assert cuda_knn.smem_bytes(k, G, bq) == plan["smem_bytes"] <= 232_448, (L, k)
        assert G * groups >= L and (G - 1) * groups < L, (L, k, G, groups)
        device = cuda_knn.knn_list_mode(k) == "device"

        def fewest_groups(b):
            widest = max(g for g in range(1, min(L, cuda_knn.MAX_GROUP) + 1)
                         if g == 1 or cuda_knn.smem_bytes(k, g, b) <= 232_448)
            return -(-L // (1 if device else widest))  # the heaps set the time there

        assert bq in cuda_knn.QUERY_BLOCKS and (bq == 64 or not device)
        assert groups == (fewest_groups(64) if device
                          else min(map(fewest_groups, cuda_knn.QUERY_BLOCKS))), (L, k)
        assert 1 <= plan["ranges"] <= cuda_knn.MAX_RANGES
    for nq, n, k in ((4096, 200_000, 5), (257, 2049, 3), (1, 129, 25), (300, 5000, 300)):
        plan = cuda_knn.knn_plan(nq, n, L, k)
        ranges = cuda_knn.row_ranges(n, plan["ranges"])
        assert len(ranges) == plan["ranges"]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(j1 > j0 and j0 % 128 == 0 for j0, j1 in ranges)


def _split_case(name):
    """(Q, Xt, W, k, P) for the range-split cases; integer data, so every
    distance is exact and ties are exact."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "duplicated_rows":  # every row twice, in different ranges
        half = rng.randint(-3, 4, (500, 5)).astype(np.float32)
        Xt = np.concatenate([half, half])
        W = (rng.rand(3, 1000) > 0.3).astype(np.float32)
        k, P = 9, 4
    elif name == "lane_with_fewer_rows_than_k":
        Xt = rng.randint(-3, 4, (700, 4)).astype(np.float32)
        W = (rng.rand(2, 700) > 0.5).astype(np.float32)
        W[1] = 0.0
        W[1, [3, 390, 699]] = 1.0  # 3 rows, in two of the ranges
        k, P = 8, 3
    elif name == "ranges_not_dividing_n":  # 2,049 rows: 17 tiles over 4 ranges
        Xt = rng.randint(-4, 5, (2049, 6)).astype(np.float32)
        W = (rng.rand(2, 2049) > 0.2).astype(np.float32)
        k, P = 5, 4
    elif name in ("k45_widest_group", "k46_past_the_group"):  # L 6: 6 lanes to k 45
        Xt = rng.randint(-3, 4, (900, 5)).astype(np.float32)
        W = (rng.rand(6, 900) > 0.3).astype(np.float32)
        k, P = (45 if name.startswith("k45") else 46), 3
    else:  # device-memory lists
        Xt = rng.randint(-3, 4, (1300, 5)).astype(np.float32)
        W = (rng.rand(2, 1300) > 0.3).astype(np.float32)
        k, P = 300, 4
    Q = rng.randint(-3, 4, (40, Xt.shape[1])).astype(np.float32)
    return Q, Xt, W, k, P


SPLIT_CASES = ["duplicated_rows", "lane_with_fewer_rows_than_k", "ranges_not_dividing_n",
               "k45_widest_group", "k46_past_the_group", "k300_device_lists"]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_range_split_merge_equals_the_whole_table(name):
    """The kernel's row split in plain PyTorch: partial lists over P
    contiguous tile-aligned ranges, merged by (d2, j), equal the plain
    version over the whole table to the bit, ties (lowest index first) and
    empty slots (3.4e38, -1) included."""
    Q, Xt, W, k, P = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                      for a in _split_case(name))
    ranges = cuda_knn.row_ranges(Xt.shape[0], P)
    assert len(ranges) == P
    got = cuda_knn.knn_topk_ranges_reference(Q, Xt, W, k, ranges)
    want = cuda_knn.knn_topk_reference(Q, Xt, W, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if name == "lane_with_fewer_rows_than_k":
        assert bool((got[1][1, :, 3:] == -1).all())
        assert bool((got[0][1, :, 3:] == np.float32(cuda_knn.INF)).all())
    if name == "duplicated_rows":  # a tie across ranges keeps the lower index
        tied = got[0][..., 1:] == got[0][..., :-1]
        assert bool((got[1][..., 1:][tied] > got[1][..., :-1][tied]).all())
    L = W.shape[0]
    group = cuda_knn.lane_group(L, k)
    if name == "k45_widest_group":
        assert group == 6
    if name == "k46_past_the_group":  # five lanes of 64 queries fit: 2 groups of 3
        assert group == 3 and cuda_knn.lane_group(L, k, 32) == 6
        assert cuda_knn.knn_plan(40, 900, L, k)["query_block"] == 32  # one group
