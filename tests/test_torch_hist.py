"""Kernel B4's plain version (ops/cuda_hist.py) against the JAX package's
level histograms, on the CPU, fed the same numpy inputs.

Integer stats (the RF classification path) must be BIT-equal to the Pallas
kernel in interpret mode (``integer_stats=True``) and to the scatter form,
on the SHAPES of tests/test_pallas_hist.py, with dead rows (node id ==
n_nodes) and an L > 1 lane axis; float stats agree within 1e-5 of the
histogram's max (f32 summation order). The kernel itself runs on the card
only (tests/test_torch_kernels_gpu.py); here the wrapper must take its
plain version because the tensors lie on the CPU, and count no launch.
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
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist
from cs230_distributed_machine_learning_tpu_torch.ops import kernel_cases as kc
from cs230_distributed_machine_learning_tpu_torch.ops import trees as tt

torch.set_num_threads(1)

# (n, d, n_bins, n_nodes, kk): tests/test_pallas_hist.py's SHAPES
SHAPES = [
    (1000, 7, 16, 20, 4),
    (4097, 12, 24, 70, 8),
    (300, 3, 8, 1, 2),
    (513, 5, 32, 130, 3),
    (257, 2, 2, 9, 1),
]


def _inputs(shape, L, seed, float_stats=False):
    n, d, nb, W, kk = shape
    rng = np.random.RandomState(seed)
    local = rng.randint(0, W + 1, (L, n)).astype(np.int32)  # W = dead row
    xb = rng.randint(0, nb, (n, d)).astype(np.int32)
    if float_stats:
        SC = rng.randn(L, n, kk).astype(np.float32)
    else:
        SC = rng.randint(0, 5, (L, n, kk)).astype(np.float32)
    return local, xb, SC


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_version_bit_equal_to_pallas_and_scatter(shape):
    n, d, nb, W, kk = shape
    L = 3
    local, xb, SC = _inputs(shape, L, seed=0)
    got = cuda_hist.level_histogram_reference(
        torch.as_tensor(local), torch.as_tensor(xb), torch.as_tensor(SC), W, nb).numpy()
    assert got.shape == (L, W, d, nb, kk)
    pallas = jax.vmap(lambda l, sc: level_histogram_pallas(
        l, jnp.asarray(xb), sc, W, nb, integer_stats=True, interpret=True))(
        jnp.asarray(local), jnp.asarray(SC))
    scatter = jax.vmap(lambda l, sc: level_histogram_scatter(
        l, jnp.asarray(xb), sc, W, nb))(jnp.asarray(local), jnp.asarray(SC))
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(scatter))


def test_plain_version_float_stats_tolerance():
    shape = (2000, 6, 16, 30, 3)
    local, xb, SC = _inputs(shape, 2, seed=1, float_stats=True)
    got = cuda_hist.level_histogram_reference(
        torch.as_tensor(local), torch.as_tensor(xb), torch.as_tensor(SC), 30, 16).numpy()
    want = np.asarray(jax.vmap(lambda l, sc: level_histogram_pallas(
        l, jnp.asarray(xb), sc, 30, 16, interpret=True))(jnp.asarray(local), jnp.asarray(SC)))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch(monkeypatch):
    local, xb, SC = _inputs((700, 5, 12, 17, 4), 2, seed=3)
    args = (torch.as_tensor(local), torch.as_tensor(xb), torch.as_tensor(SC), 17, 12)
    cuda_hist.reset_launches()
    for mode in ("auto", "pallas", "scatter", "matmul"):
        monkeypatch.setenv("CS230_HIST_KERNEL", mode)
        got = tt._level_histogram_multi(args[0], (args[1],), args[2], 17, (12,),
                                        integer_stats=True)[0]
        assert torch.equal(got, cuda_hist.level_histogram_reference(*args))
    assert torch.equal(cuda_hist.level_histogram(*args, integer_stats=True),
                       cuda_hist.level_histogram_reference(*args))
    assert cuda_hist.LAUNCHES["level_histogram"] == 0


def test_hist_with_count_derives_the_count_column():
    """Classification stats sum to the count: the count histogram is the sum
    of the class histograms (the reference's count_from_stats)."""
    rng = np.random.RandomState(4)
    n, d, nb, W, k, L = 600, 4, 8, 5, 3, 2
    y = rng.randint(0, k, n)
    w = rng.randint(0, 3, (L, n)).astype(np.float32)
    S = np.eye(k, dtype=np.float32)[y][None] * w[..., None]
    SC = torch.as_tensor(np.concatenate([S, w[..., None]], axis=-1))
    local = torch.as_tensor(rng.randint(0, W, (L, n)))
    xb = torch.as_tensor(rng.randint(0, nb, (n, d)).astype(np.int32))
    H = tt._hist_with_count(local, xb, SC, W, nb, k, True)
    full = cuda_hist.level_histogram_reference(local, xb, SC, W, nb)
    assert torch.equal(H, full)


@pytest.mark.parametrize("n_nodes,d,n_bins,kk,L", [
    (1, 54, 48, 7, 6), (128, 54, 24, 7, 6), (128, 54, 48, 7, 6),
    (1536, 54, 16, 7, 6), (4, 4, 128, 3, 15), (130, 5, 32, 3, 3),
])
def test_kernel_tiling_fits_shared_memory(n_nodes, d, n_bins, kk, L):
    """The page of every CTA fits its budget and passes the kernel's own
    shared-memory gate (csrc/hist.cu; the pages hold no row list since
    the rows are bucketed by node first): the geometry is plain
    arithmetic, held here because the kernel runs on the card only."""
    Mb, Fb = cuda_hist.hist_tile(n_nodes, d, n_bins, kk, L)
    assert 1 <= Mb <= n_nodes and 1 <= Fb <= d
    page = cuda_hist.page_bytes(Mb, Fb, n_bins, kk)
    assert page <= cuda_hist.PAGE_BYTES
    assert page <= cuda_hist.SMEM_LIMIT - 1024
    assert cuda_hist.hist_applicable(n_bins, kk)


SKEWED = list(kc.SKEWED_LEVELS)


@pytest.mark.parametrize("kind", SKEWED)
def test_bucket_rows_reference_matches_numpy_sort(kind):
    """The bucketing pass's plain mirror: offsets are the exclusive scan
    of the live rows' node counts, and each node's segment holds exactly
    its live rows, as a stable numpy sort by node gives them; rows whose
    stats are all zero drop out when the stats are given."""
    rng = np.random.RandomState(SKEWED.index(kind))
    L, n, n_nodes = 3, 3000, 97
    local = kc.skewed_node_ids(kind, L, n, n_nodes, rng).astype(np.int32)
    SC = rng.randint(0, 3, (L, n, 4)).astype(np.float32) * (rng.rand(L, n, 1) < 0.6)
    for stats in (None, SC):
        off, rows = cuda_hist.bucket_rows_reference(
            torch.as_tensor(local), n_nodes, None if stats is None else torch.as_tensor(stats))
        off, rows = off.numpy(), rows.numpy()
        assert off.shape == (L, n_nodes + 1) and rows.shape == (L, n)
        for lane in range(L):
            live = (local[lane] >= 0) & (local[lane] < n_nodes)
            if stats is not None:
                live &= (stats[lane] != 0).any(-1)
            want_counts = np.bincount(local[lane][live], minlength=n_nodes)
            np.testing.assert_array_equal(off[lane], np.concatenate([[0], np.cumsum(want_counts)]))
            key = np.where(live, local[lane], n_nodes)
            order = np.argsort(key, kind="stable")[:live.sum()]
            np.testing.assert_array_equal(rows[lane, :live.sum()], order)
            assert (rows[lane, live.sum():] == -1).all()


@pytest.mark.parametrize("kind", SKEWED)
@pytest.mark.parametrize("n_nodes,d,n_bins,kk,L", [(97, 6, 8, 4, 3), (1536, 54, 16, 7, 6)])
def test_page_cut_fits_and_covers_every_node(kind, n_nodes, d, n_bins, kk, L):
    """The device's page cut (its plain mirror) on skewed levels: pages are
    runs of consecutive nodes that cover every node once, hold at most Mb
    nodes (so each fits its shared-memory page), number at most the
    grid's max_pages, and carry at most T rows beside their largest node."""
    rng = np.random.RandomState(len(kind) + n_nodes)
    n = 4000
    local = torch.as_tensor(kc.skewed_node_ids(kind, L, n, n_nodes, rng).astype(np.int32))
    Mb, Fb = cuda_hist.hist_tile(n_nodes, d, n_bins, kk, L)
    T, max_pages = cuda_hist.hist_pages(n, n_nodes, Mb)
    assert cuda_hist.page_bytes(min(Mb, n_nodes), Fb, n_bins, kk) <= cuda_hist.SMEM_LIMIT - 1024
    assert cuda_hist.scratch_ints(L, n, n_nodes, max_pages) == L * (2 * n_nodes + n + max_pages + 3)
    off, _ = cuda_hist.bucket_rows_reference(local, n_nodes)
    for lane in range(L):
        starts = cuda_hist.page_starts_reference(off[lane], Mb, T).numpy()
        sizes = np.diff(starts)
        assert starts[0] == 0 and starts[-1] == n_nodes and (sizes >= 1).all()
        assert (sizes <= Mb).all() and len(sizes) <= max_pages
        o = off[lane].numpy()
        for a, b in zip(starts[:-1], starts[1:]):
            rows = o[b] - o[a]
            assert rows <= T + np.diff(o[a:b + 1]).max()


@pytest.mark.parametrize("kind", SKEWED)
def test_pages_over_bucketed_rows_give_the_histogram(kind):
    """The kernel's design in plain arithmetic: each page sums only its
    nodes' segments of the bucketed row list, and the pages together give
    the plain version's histogram to the bit (integer stats)."""
    rng = np.random.RandomState(10 + SKEWED.index(kind))
    L, n, d, n_bins, n_nodes, kk = 2, 2500, 5, 6, 40, 3
    local = torch.as_tensor(kc.skewed_node_ids(kind, L, n, n_nodes, rng).astype(np.int32))
    xb = torch.as_tensor(rng.randint(0, n_bins, (n, d)).astype(np.int32))
    SC = torch.as_tensor((rng.randint(0, 3, (L, n, kk)) * (rng.rand(L, n, 1) < 0.7))
                         .astype(np.float32))
    want = cuda_hist.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    Mb, _ = cuda_hist.hist_tile(n_nodes, d, n_bins, kk, L)
    T, _ = cuda_hist.hist_pages(n, n_nodes, Mb)
    off, rows = cuda_hist.bucket_rows_reference(local, n_nodes, SC)
    got = torch.zeros_like(want)
    for lane in range(L):
        starts = cuda_hist.page_starts_reference(off[lane], Mb, T).tolist()
        for m0, m1 in zip(starts[:-1], starts[1:]):
            seg = rows[lane, off[lane, m0]:off[lane, m1]].long()
            page = cuda_hist.level_histogram_reference(
                local[lane:lane + 1, seg] - m0, xb[seg], SC[lane:lane + 1, seg], m1 - m0, n_bins)
            got[lane, m0:m1] = page[0]
    assert torch.equal(got, want)
