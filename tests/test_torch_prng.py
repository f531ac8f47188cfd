"""The port's threefry generator (utils/prng.py) against ``jax.random``, bit
for bit, for every call and shape the tree and MLP paths make: PRNGKey,
fold_in (scalar and batched over arena node ids), split, uniform (the
feature subsets of both builders, and the MLP's bounded Glorot init),
randint with a shared and a per-lane ``maxval`` (the bootstrap), bits (the
MLP's stochastic rounding) and permutation (its epoch shuffles, 1 sort
round at small n and 2 at 60,000)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1]


def _key(jk):
    """A raw uint32 JAX key as the port's int64 words."""
    return np.asarray(jk).astype(np.int64)


def test_partitionable_threefry_is_the_reference_mode():
    """The port follows the split/random_bits layout of
    ``jax_threefry_partitionable=True``, the installed JAX's default."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_key(jk), tk.numpy())
    for t in (0, 1, 7, 99, 2**20):
        np.testing.assert_array_equal(_key(jax.random.fold_in(jk, t)),
                                      prng.fold_in(tk, t).numpy())
    np.testing.assert_array_equal(_key(jax.random.split(jk)), prng.split(tk).numpy())
    np.testing.assert_array_equal(_key(jax.random.split(jk, 5)), prng.split(tk, 5).numpy())
    # a tree key, its bootstrap / feature halves, and a level's subkey
    jt, tt = jax.random.fold_in(jk, 3), prng.fold_in(tk, 3)
    jb, jf = jax.random.split(jt)
    tb, tf = prng.split(tt).unbind(-2)
    np.testing.assert_array_equal(_key(jb), tb.numpy())
    np.testing.assert_array_equal(_key(jax.random.split(jf)[1]),
                                  prng.split(tf).unbind(-2)[1].numpy())


@pytest.mark.parametrize("shape", [(1, 4), (7, 54), (64, 12), (3,)])
def test_uniform(shape):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(tk, shape).numpy())


def test_uniform_over_folded_node_ids():
    """The deep builder's per-node subsets: one fold_in per arena id, a
    batched key tensor here, a vmap there."""
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    ids = np.array([[0, 3, 17, 999, 0], [1, 2, 4, 8, 16]])
    want = jax.vmap(jax.vmap(
        lambda c: jax.random.uniform(jax.random.fold_in(jk, c), (54,))))(ids)
    got = prng.uniform(prng.fold_in(tk, torch.as_tensor(ids)), (54,))
    assert got.shape == (2, 5, 54)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("maxval", [1, 2, 3, 150, 65536, 65537, 116_202, 2**20 + 3])
def test_randint_shared_bound(maxval):
    jk, tk = jax.random.PRNGKey(42), prng.PRNGKey(42)
    want = jax.random.randint(jk, (2000,), 1, maxval + 1)
    got = prng.randint(tk, (2000,), 1, maxval + 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_randint_per_lane_bound():
    """The bootstrap's draw: one key for every lane, the bound (active row
    count + 1) per lane; 0 active rows clamps to 1."""
    jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
    n_active = np.array([0, 5, 1000, 116_202, 70_000], np.int32)
    want = jax.vmap(lambda m: jax.random.randint(jk, (500,), 1, jnp.maximum(m, 1) + 1))(
        jnp.asarray(n_active))
    got = prng.randint(tk, (500,), 1,
                       torch.clamp(torch.as_tensor(n_active, dtype=torch.int64), min=1)[:, None] + 1)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", [7, 1000, 60_000])
@pytest.mark.parametrize("seed", [0, 42])
def test_permutation(n, seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for e, (je, te) in enumerate(zip(jax.random.split(jk, 2), prng.split(tk, 2))):
        want = np.asarray(jax.random.permutation(je, n))
        np.testing.assert_array_equal(want, prng.permutation(te, n).numpy(), err_msg=str(e))


@pytest.mark.parametrize("shape", [(7,), (20, 32), (784, 128)])
def test_bits(shape):
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for k in range(3):  # the stochastic-rounding stream's per-step leaf keys
        jkk = jax.random.split(jax.random.fold_in(jk, k + 1), 3)[k]
        tkk = prng.split(prng.fold_in(tk, k + 1), 3)[k]
        want = np.asarray(jax.random.bits(jkk, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(want, prng.bits(tkk, shape).numpy())


@pytest.mark.parametrize("fan_in,fan_out", [(784, 512), (512, 10), (20, 32)])
@pytest.mark.parametrize("seed", [0, 1000])
def test_uniform_bounded(fan_in, fan_out, seed):
    """The Glorot draw: bounds +-f32(sqrt(6 / (fan_in + fan_out))). XLA
    fuses the affine map into a multiply-add; the port matches its bits."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bound = jnp.sqrt(6.0 / (fan_in + fan_out))
    want = np.asarray(jax.random.uniform(jk, (fan_in, fan_out), jnp.float32, -bound, bound))
    got = prng.uniform(tk, (fan_in, fan_out), -float(bound), float(bound)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
