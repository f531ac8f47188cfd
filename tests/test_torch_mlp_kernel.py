"""The MLP epoch kernel's plain version (ops/cuda_mlp.py, kernel B5)
against the JAX package's Pallas epoch kernel (``build_epoch_fn``) in
interpret mode, on the CPU, fed the same numpy inputs.

One short epoch from a random state (params, moments or velocities, a
ragged batch's zero-weight slots), for adam and sgd (Nesterov on and off),
with and without the loss accumulator, every hidden activation, 1-3 hidden
layers, classifier and regressor. In interpret mode the Pallas kernel
computes its products in f32, and so does the plain version given f32
rows. Tolerance: every state tensor within 1e-5 of its max (measured
~2e-7: the two sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.ops.pallas_mlp import build_epoch_fn
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_mlp

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)

TOL = 1e-5


def _inputs(dims, bs, nb, L, classification, solver, track, ragged, seed):
    """Rows, targets, split weights, hypers and a state, as numpy: the JAX
    state with its [L, 8, dout] bias slabs and [L, 8, 128] loss slab."""
    rng = np.random.RandomState(seed)
    R = nb * bs
    X = rng.randn(R, dims[0]).astype(np.float32)
    if classification:
        Y = np.eye(dims[-1], dtype=np.float32)[rng.randint(0, dims[-1], R)]
    else:
        Y = rng.randn(R, 1).astype(np.float32)
    Wl = (rng.rand(nb, bs, L) > 0.3).astype(np.float32)
    if ragged:
        Wl[:, bs - ragged:, :] = 0.0  # padded slots
    lr = (10 ** rng.uniform(-3, -1.5, L)).astype(np.float32)
    alpha = (10 ** rng.uniform(-5, -2, L)).astype(np.float32)
    state = []
    for din, dout in zip(dims[:-1], dims[1:]):
        state.append((rng.randn(L, din, dout) * 0.3).astype(np.float32))
        state.append(np.repeat((rng.randn(L, 1, dout) * 0.1).astype(np.float32), 8, 1))
        for _ in range(cuda_mlp.per_layer(solver) // 2 - 1):
            scale = 1e-2 if solver == "sgd" else 1e-4
            state.append(np.abs(rng.randn(L, din, dout) * scale).astype(np.float32))
            state.append(np.repeat(np.abs(rng.randn(L, 1, dout) * scale).astype(np.float32), 8, 1))
    if track:
        state.append(np.full((L, 8, 128), 0.25, np.float32))
    return X, Y, Wl.reshape(R, L), lr, alpha, state


@pytest.mark.parametrize("dims,act,bs,nb,L,cls,solver,nest,track,ragged", [
    ((12, 16, 3), "relu", 32, 3, 4, True, "adam", True, False, 0),
    ((12, 16, 8, 3), "tanh", 32, 3, 4, True, "sgd", True, True, 0),
    ((12, 16, 1), "logistic", 32, 3, 4, False, "sgd", False, True, 0),
    ((12, 16, 8, 8, 3), "identity", 40, 2, 3, True, "adam", True, True, 5),
    ((20, 32, 1), "relu", 64, 2, 2, False, "adam", True, False, 3),
])
def test_epoch_plain_matches_pallas_interpret(dims, act, bs, nb, L, cls, solver, nest,
                                              track, ragged):
    X, Y, Wl, lr, alpha, state = _inputs(dims, bs, nb, L, cls, solver, track, ragged, seed=0)
    t0 = 5
    fn = build_epoch_fn(dims, act, bs, nb, L, 1, cls, solver=solver, nesterov=nest,
                        track_loss=track, interpret=True)
    want = fn(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Wl), jnp.asarray(lr[:, None]),
              jnp.asarray(alpha[:, None]), jnp.asarray([[t0]], jnp.int32),
              [jnp.asarray(s) for s in state])
    want = cuda_mlp.state_from_jax([np.asarray(w) for w in want], solver, track)

    got = cuda_mlp.state_from_jax(state, solver, track)
    cuda_mlp.reset_launches()
    out = cuda_mlp.epoch(torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(Wl),
                         torch.as_tensor(lr), torch.as_tensor(alpha), t0, got, dims=dims,
                         act=act, bs=bs, n_batches=nb, classification=cls, solver=solver,
                         nesterov=nest, track_loss=track)
    assert out is got  # updated in place
    assert cuda_mlp.LAUNCHES["mlp_epoch"] == 0  # the CPU runs the plain version
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        err = float((g - w).abs().max() / w.abs().max())
        assert err < TOL, (i, err)


def test_state_from_jax_takes_the_slabs_apart():
    rng = np.random.RandomState(1)
    dims, L = (5, 4, 3), 2
    _, _, _, _, _, state = _inputs(dims, 8, 1, L, True, "adam", True, 0, seed=1)
    got = cuda_mlp.state_from_jax(state, "adam", track_loss=True)
    assert [tuple(t.shape) for t in got] == [
        (L, 5, 4), (L, 4), (L, 5, 4), (L, 4), (L, 5, 4), (L, 4),
        (L, 4, 3), (L, 3), (L, 4, 3), (L, 3), (L, 4, 3), (L, 3), (L,)]
    np.testing.assert_array_equal(got[1].numpy(), state[1][:, 0, :])
    np.testing.assert_array_equal(got[-1].numpy(), np.full(L, 0.25, np.float32))
    params = [{"W": rng.randn(5, 4).astype(np.float32), "b": np.zeros(4, np.float32)}]
    tp = cuda_mlp.params_from_jax(params)
    np.testing.assert_array_equal(tp[0]["W"].numpy(), params[0]["W"])
    with pytest.raises(ValueError):
        cuda_mlp.state_from_jax(state[:5], "adam")


def test_epoch_state_layout():
    """The fused path's initial state: params replicated over lanes, zero
    moments, in the TPU kernel's per-layer order."""
    params = [{"W": torch.randn(3, 4), "b": torch.randn(4)},
              {"W": torch.randn(4, 2), "b": torch.randn(2)}]
    for solver, k in (("adam", 6), ("sgd", 4)):
        st = cuda_mlp.epoch_state(params, 5, solver, track_loss=True)
        assert len(st) == 2 * k + 1 and tuple(st[-1].shape) == (5,)
        for li, layer in enumerate(params):
            assert torch.equal(st[k * li][3], layer["W"])
            assert torch.equal(st[k * li + 1][0], layer["b"])
            assert all(float(t.abs().max()) == 0.0 for t in st[k * li + 2: k * (li + 1)])


def test_epoch_cost_model():
    """The bound's inputs at the config-5 shape (784-512-10, bs 256, 234
    steps, 75 lanes): 7.35 TFLOP of products; the state once plus the
    batch rows, and the state plus the bf16 weight shadow at every step."""
    dims = (784, 512, 10)
    assert cuda_mlp.epoch_flops(dims, 256, 234, 75) == pytest.approx(7.35e12, rel=1e-2)
    once = cuda_mlp.epoch_bytes(dims, 256, 234, 75)
    every = cuda_mlp.epoch_bytes(dims, 256, 234, 75, every_step=True)
    params = 784 * 512 + 512 + 512 * 10 + 10
    weights = 784 * 512 + 512 * 10
    assert once == 24 * params * 75 + 234 * 256 * (2 * 784 + 4 * 10 + 4 * 75)
    assert every - once == 24 * params * 75 * 233 + 2 * weights * 75 * 234
    # bf16 shadows [din][pad8(dout)], hidden f32 + bf16 activations, f32
    # logits, bf16 output gradients, in f32 units
    assert cuda_mlp.scratch_floats(dims, 256) == (
        (784 * 512 + 512 * 16) // 2 + 256 * 512 + 256 * 512 // 2 + 256 * 10
        + 256 * 512 // 2 + 256 * 16 // 2)


@pytest.mark.parametrize("dims,bs", [
    ((784, 512, 10), 256), ((784, 256, 128, 10), 128), ((20, 32, 16, 8, 5), 64),
    ((33, 24, 24, 3), 50), ((5, 3, 7, 1), 40),
])
def test_scratch_holds_the_weight_shadows_epoch_bytes_counts(dims, bs):
    """The scratch holds one bf16 shadow of every weight, rows padded to 8
    columns, and each of its pieces starts 16-byte aligned: the shadow
    bytes written at every step (``epoch_bytes(every_step=True)`` less
    the state's) are what the scratch's shadows take, before the padding."""
    L, steps = 3, 4
    floats = cuda_mlp.scratch_floats(dims, bs)
    assert floats % 4 == 0
    weights = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    every = cuda_mlp.epoch_bytes(dims, bs, steps, L, every_step=True)
    rows = cuda_mlp.epoch_bytes(dims, bs, steps, L) - 24 * params * L
    shadow_bytes = (every - rows - 24 * params * L * steps) // (L * steps)
    assert shadow_bytes == 2 * weights
    padded = sum(a * -(-b // 8) * 8 for a, b in zip(dims[:-1], dims[1:]))
    assert 4 * floats >= 2 * padded + 4 * bs * sum(dims[1:])


def test_kernel_cases_load_by_path_and_hold_b5_on_cpu():
    """``ops/kernel_cases.py`` loads from its file alone (as the A/B timer
    loads it beside another checkout's package), and its B5 check, on CPU
    tensors where the wrapper runs the plain version, finds no error at a
    small shape: 6 lanes of the 6 splits, one step and two."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(cuda_mlp.__file__), "kernel_cases.py")
    spec = importlib.util.spec_from_file_location("kernel_cases_alone", path)
    kc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kc)
    gen = torch.Generator().manual_seed(5)
    dims, bs, L = (12, 16, 3), 8, 6
    X, Y, Wl, lr, alpha, params = kc.mlp_inputs(gen, torch.device("cpu"), dims, bs, 2, L)
    assert X.dtype == torch.bfloat16 and Wl.shape == (2 * bs, L)
    kw = dict(dims=dims, act="relu", bs=bs, classification=True)
    for nb in (1, 2):
        part = (X[:nb * bs], Y[:nb * bs], Wl[:nb * bs].contiguous(), lr, alpha)
        for solver in ("adam", "sgd"):
            got = kc.mlp_check(cuda_mlp, part, params, L, solver, dict(kw, n_batches=nb))
            assert got["param_abs"] == 0.0 and got["mean_rel"] == 0.0, (solver, nb, got)
    assert set(kc.MLP_LIMITS) == {(c, s) for c in ("step", "epoch") for s in ("adam", "sgd")}
