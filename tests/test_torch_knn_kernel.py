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
    source's layout, the largest k with shared-memory lists fits an H100
    CTA, and lists in device memory take no shared memory."""
    assert cuda_knn.smem_bytes(5) == 88_832
    assert cuda_knn.smem_bytes(cuda_knn.SHARED_LISTS_MAX_K) <= 232_448
    assert cuda_knn.smem_bytes(300) == cuda_knn.smem_bytes(1000) == 88_832 - 64 * 5 * 8
    assert cuda_knn.knn_operations(6, 4096, 200_000, 54) == pytest.approx(9.338e10, rel=1e-3)
