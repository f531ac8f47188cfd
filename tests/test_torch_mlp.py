"""The PyTorch port's MLP kernels (models/mlp.py) against the JAX
package's, on the CPU, fed the same numpy inputs.

- The random streams, bit for bit: the Glorot init, the stochastic
  rounding of the bf16 second moment (``_sr_bf16``).
- The generic path: ``batched_scores`` over a [T, S] lane axis against the
  JAX engine's ``_make_batched`` (vmap of ``fit_curve`` / ``evaluate``):
  Adam with the bf16 moments (relu, tanh over two hidden layers, a
  logistic regressor, and the f32 second moment), and ``_fit_sgd`` under
  its three learning-rate schedules. Scores within 2e-3 (measured 0 for
  the classifiers: both round the products' operands, and the gradients
  of bf16 operands, at the same places), regression r2 / MSE within 1e-4
  of their max, curve leaves within 1e-2 of their max (a gradient's bf16
  rounding can land one ulp apart; measured 3.5e-3).
- The fused path: ``build_batched_fn`` under ``CS230_FORCE_PACKED=1``
  (the epoch kernel's plain version, f32) against the JAX fused fn under
  ``CS230_PALLAS_INTERPRET=1``. Scores are held by the count of eval rows,
  as the LogReg packed path's are: at most 2 rows apart in a lane and 1 in
  1,000 lane-eval rows overall (measured 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.models import mlp as jmlp
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jax_tm
from cs230_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel as torch_kernel
from cs230_distributed_machine_learning_tpu_torch.utils import prng

CPU = torch.device("cpu")

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)

MAX_ROWS_PER_LANE = 2
MAX_ROWS_PER_1000 = 1


def _problem(name, n, d=10, c=3, T=3, S=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    if name == "MLPRegressor":
        y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
        c = 0
    else:
        y = np.argmax(X @ rng.randn(d, c) + 0.5 * rng.randn(n, c), 1).astype(np.int32)
    TW = (rng.rand(S, n) > 0.3).astype(np.float32)
    EW = (rng.rand(S, n) > 0.5).astype(np.float32)
    hyper = {"alpha": np.geomspace(1e-5, 1e-2, T).astype(np.float32),
             "learning_rate_init": np.geomspace(1e-3, 3e-2, T).astype(np.float32)}
    return X, y, c, TW, EW, hyper


def _static(kernel, params, n, d, c):
    key, _ = kernel.canonicalize(params)
    static = kernel.resolve_static(kernel.static_from_key(key), n, d, c)
    static["_n_classes"] = c
    return static


def _jax_args(X, y, TW, EW, hyper):
    return (jnp.asarray(X), jnp.asarray(y), jnp.asarray(TW), jnp.asarray(EW),
            {k: jnp.asarray(v) for k, v in hyper.items()})


def _torch_args(X, y, TW, EW, hyper):
    return (torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(TW), torch.as_tensor(EW),
            {k: torch.as_tensor(v) for k, v in hyper.items()})


def test_init_is_the_reference_draw():
    dims = (20, 32, 16, 5)
    want = jmlp.MLPClassifierKernel()._init(jax.random.PRNGKey(7), dims)
    got = tmlp.MLPClassifierKernel()._init(prng.PRNGKey(7), dims)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w["W"]), g["W"].numpy())
        np.testing.assert_array_equal(np.asarray(w["b"]), g["b"].numpy())


def test_sr_bf16_is_bit_equal():
    rng = np.random.RandomState(0)
    x = (np.abs(rng.randn(4, 33, 17)) * 10.0 ** rng.uniform(-9, 1, (4, 33, 17))).astype(np.float32)
    x[0, 0, :3] = [0.0, 1.0, np.float32(np.finfo(np.float32).max) / 4]
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0x5A), 4)[2]
    want = jax.vmap(lambda a: jmlp._sr_bf16(a, key))(jnp.asarray(x))
    tkey = prng.split(prng.fold_in(prng.PRNGKey(0), 0x5A), 4)[2]
    got = tmlp._sr_bf16(torch.as_tensor(x), tkey)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)), got.float().numpy())


@pytest.mark.parametrize("name,params,v_dtype", [
    ("MLPClassifier", {"hidden_layer_sizes": (16,), "max_iter": 3, "batch_size": 64}, "bf16"),
    ("MLPClassifier", {"hidden_layer_sizes": [16, 8], "max_iter": 2, "batch_size": 50,
                       "activation": "tanh"}, "f32"),
    ("MLPRegressor", {"hidden_layer_sizes": (16,), "max_iter": 3, "batch_size": 64,
                      "activation": "logistic"}, "bf16"),
    ("MLPClassifier", {"hidden_layer_sizes": (16,), "max_iter": 3, "batch_size": 64,
                       "solver": "sgd"}, "bf16"),
    ("MLPClassifier", {"hidden_layer_sizes": (16,), "max_iter": 3, "batch_size": 60,
                       "solver": "sgd", "learning_rate": "invscaling",
                       "nesterovs_momentum": False}, "bf16"),
    ("MLPClassifier", {"hidden_layer_sizes": (16,), "max_iter": 4, "batch_size": 64,
                       "solver": "sgd", "learning_rate": "adaptive", "n_iter_no_change": 1,
                       "tol": 10.0, "activation": "identity"}, "bf16"),
])
def test_generic_path_matches_jax(monkeypatch, name, params, v_dtype):
    monkeypatch.setenv("CS230_MLP_V_DTYPE", v_dtype)
    n, d = 300, 10
    X, y, c, TW, EW, hyper = _problem(name, n, d)
    jk, tk = jax_kernel(name), torch_kernel(name)
    jfn = jax.jit(jax_tm._make_batched(jk, _static(jk, params, n, d, c), True))
    want = {k: np.asarray(v) for k, v in jfn(*_jax_args(X, y, TW, EW, hyper)).items()}
    got = tk.batched_scores(*_torch_args(X, y, TW, EW, hyper), _static(tk, params, n, d, c))
    got = {k: v.numpy() for k, v in got.items()}
    assert got.keys() == want.keys()
    curves = ["curve_loss"] + (["curve_gmax"] if params.get("solver") != "sgd" else [])
    assert sorted(k for k in got if k.startswith("curve_")) == sorted(
        curves + ["curve_steps", "curve_stride"])
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k == "score" and name == "MLPClassifier":
            assert np.abs(g - w).max() <= 2e-3
        elif k in ("score", "mse"):
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k
        elif k in ("curve_steps", "curve_stride"):
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), k


@pytest.mark.parametrize("name,params", [
    ("MLPClassifier", {"hidden_layer_sizes": (16,), "max_iter": 2, "batch_size": 64}),
    ("MLPRegressor", {"hidden_layer_sizes": [8, 8], "max_iter": 2, "batch_size": 60,
                      "activation": "tanh", "solver": "sgd",
                      "learning_rate": "invscaling"}),
    ("MLPClassifier", {"hidden_layer_sizes": (8,), "max_iter": 3, "batch_size": 64,
                       "solver": "sgd", "learning_rate": "adaptive", "n_iter_no_change": 1,
                       "tol": 10.0}),
])
def test_fused_path_matches_jax_interpret(monkeypatch, name, params):
    from cs230_distributed_machine_learning_tpu.ops import pallas_mlp

    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    monkeypatch.setenv("CS230_PALLAS_INTERPRET", "1")
    # one lane a grid step: k only groups lanes (the scores do not depend
    # on it), and a smaller unrolled body keeps the interpret run short
    monkeypatch.setattr(pallas_mlp, "pick_k", lambda *a, **k: 1)
    n, d, T, S = 256, 8, 2, 3
    X, y, c, TW, EW, hyper = _problem(name, n, d, T=T, S=S, seed=1)
    jk, tk = jax_kernel(name), torch_kernel(name)
    jfn = jk.build_batched_fn(static=_static(jk, params, n, d, c), n=n, d=d, n_classes=c,
                              n_splits=S, chunk=T)
    want = {k: np.asarray(v) for k, v in jfn(*_jax_args(X, y, TW, EW, hyper)).items()}
    tfn = tk.build_batched_fn(static=_static(tk, params, n, d, c), n=n, d=d, n_classes=c,
                              n_splits=S, chunk=T, device=CPU)
    got = {k: v.numpy() for k, v in tfn(*_torch_args(X, y, TW, EW, hyper)).items()}
    # the port's fused path adds the per-epoch loss curve (curves are on by
    # default), which the JAX fused path does not emit
    assert got.keys() == want.keys() | {"curve_loss", "curve_stride", "curve_steps"}
    assert got["curve_loss"].shape == (T, S, params["max_iter"])
    assert np.isfinite(got["curve_loss"]).all()
    n_eval = EW.sum(axis=1)[None, :]
    for k, w in want.items():
        assert got[k].shape == w.shape == (T, S)
        if name == "MLPClassifier":
            rows = np.abs(got[k] - w) * n_eval
            assert np.abs(rows - np.rint(rows)).max() < 1e-3  # whole rows
            assert np.rint(rows).max() <= MAX_ROWS_PER_LANE
            assert np.rint(rows).sum() <= MAX_ROWS_PER_1000 * (T * n_eval.sum()) / 1000
        else:
            assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def test_resolve_static_refuses_like_the_reference():
    k = torch_kernel("MLPClassifier")
    for bad in ({"solver": "lbfgs"}, {"activation": "softplus"},
                {"learning_rate": "optimal"}):
        with pytest.raises(ValueError):
            k.resolve_static({**k.static_defaults, **bad}, 100, 4, 3)
    s = k.resolve_static({**k.static_defaults, "hidden_layer_sizes": [64, 32],
                          "max_iter": 500, "batch_size": 256}, 100, 4, 3)
    assert s["_hls"] == (64, 32) and s["_bs"] == 100 and s["_epochs"] == 100


def test_list_and_tuple_sizes_share_a_bucket():
    """The model_details payload carries hidden_layer_sizes as a list; it
    buckets with the tuple a scikit-learn object gives."""
    k = torch_kernel("MLPClassifier")
    a, _ = k.canonicalize({"hidden_layer_sizes": [256, 128], "alpha": 1e-4})
    b, _ = k.canonicalize({"hidden_layer_sizes": (256, 128), "alpha": 1e-3})
    assert a == b


def test_fused_gate_routes_like_the_reference(monkeypatch):
    monkeypatch.delenv("CS230_FORCE_PACKED", raising=False)
    k = torch_kernel("MLPClassifier")
    cuda = torch.device("cuda")
    s = k.resolve_static(dict(k.static_defaults), 60_000, 784, 10)
    assert k.batched_applicable(s, 60_000, 784, cuda)
    assert not k.batched_applicable(s, 60_000, 784, CPU)
    assert not k.batched_applicable(s, 4095, 784, cuda)
    assert not k.batched_applicable({**s, "early_stopping": True}, 60_000, 784, cuda)
    assert not k.batched_applicable({**s, "_hls": (8, 8, 8, 8)}, 60_000, 784, cuda)
    assert k.build_batched_fn({**s, "_n_classes": 10, "beta_1": 0.8}, 60_000, 784, 10, 6,
                              4, cuda) is None
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    assert k.batched_applicable(s, 300, 4, CPU)


def test_single_model_predictions_match_jax():
    rng = np.random.RandomState(2)
    X = rng.randn(40, 6).astype(np.float32)
    jparams = jmlp.MLPClassifierKernel()._init(jax.random.PRNGKey(3), (6, 9, 3))
    jparams[0]["b"] = jnp.asarray(rng.randn(9).astype(np.float32))
    static = {"activation": "tanh", "_n_classes": 3}
    from cs230_distributed_machine_learning_tpu_torch.ops.cuda_mlp import params_from_jax

    tparams = params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in jparams])
    jc, tc = jmlp.MLPClassifierKernel(), tmlp.MLPClassifierKernel()
    Xt = torch.as_tensor(X)
    np.testing.assert_array_equal(np.asarray(jc.predict(jparams, jnp.asarray(X), static)),
                                  tc.predict(tparams, Xt, static).numpy())
    for fn in ("predict_proba", "predict_margin"):
        np.testing.assert_allclose(getattr(tc, fn)(tparams, Xt, static).numpy(),
                                   np.asarray(getattr(jc, fn)(jparams, jnp.asarray(X), static)),
                                   rtol=1e-5, atol=1e-6)
    jr, tr = jmlp.MLPRegressorKernel(), tmlp.MLPRegressorKernel()
    rparams = jr._init(jax.random.PRNGKey(4), (6, 5, 1))
    np.testing.assert_allclose(
        tr.predict(params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in rparams]),
                   Xt, static).numpy(),
        np.asarray(jr.predict(rparams, jnp.asarray(X), static)), rtol=1e-5, atol=1e-6)
