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
    """The page of every CTA fits its budget, and page plus row list pass
    the kernel's own shared-memory gate (csrc/hist.cu): the geometry is
    plain arithmetic, held here because the kernel runs on the card only."""
    Mb, Fb = cuda_hist.hist_tile(n_nodes, d, n_bins, kk, L)
    assert 1 <= Mb <= n_nodes and 1 <= Fb <= d
    page = cuda_hist.page_bytes(Mb, Fb, n_bins, kk)
    assert page <= cuda_hist.PAGE_BYTES
    assert page + cuda_hist.LIST_BYTES <= cuda_hist.SMEM_LIMIT - 1024
    assert cuda_hist.hist_applicable(n_bins, kk)
