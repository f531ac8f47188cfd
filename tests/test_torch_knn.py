"""The PyTorch port's KNN kernels (models/knn.py) against the JAX package's,
on the CPU, fed the same numpy inputs.

- The generic path (streamed top-k: k min-extractions for k <= 16, a
  stable sort above): ``batched_scores`` over a lane axis against the JAX
  package's vmap of ``fit`` / ``evaluate``, at k 5 and 20, for both
  families and both weightings.
- The kernel path: the port under ``CS230_FORCE_PACKED=1`` (B6's plain
  version) against the JAX package with ``_use_pallas`` patched to True
  and its Pallas kernel in interpret mode (patched here, in the test;
  nothing in the JAX package changes).
- The chunked protocol (``_run_chunked`` over query chunks, the last one
  ragged) equal to the monolithic run, and ``chunked_plan`` equal to the
  reference's on both sides of the 150,000-row gate.

Tolerances: classification scores within 2 eval rows a lane (a distance
within f32 rounding of a neighbour's can swap it: XLA and PyTorch sum the
dot products in other orders); r2 and MSE within 1e-4 of their largest
magnitude.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.models import knn as jk
from cs230_distributed_machine_learning_tpu.ops import pallas_knn
from cs230_distributed_machine_learning_tpu_torch.models import knn as tk
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map

torch.set_num_threads(1)

FAMILIES = {
    "classification": (jk.KNNClassifierKernel, tk.KNNClassifierKernel),
    "regression": (jk.KNNRegressorKernel, tk.KNNRegressorKernel),
}


def _data(task, n=600, d=8, c=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    z = X @ rng.randn(d, c).astype(np.float32)
    if task == "classification":
        return X, np.argmax(z, axis=1).astype(np.int32), c
    return X, (z[:, 0] + 0.3 * rng.randn(n)).astype(np.float32), 0


def _static(k, weights, n, n_classes):
    static = {"n_neighbors": k, "weights": weights, "p": 2}
    static = tk.KNNClassifierKernel().resolve_static(static, n, 8, n_classes)
    static["_n_classes"] = n_classes
    return static


def _jax_scores(kernel, X, y, TW, EW, static):
    """The JAX engine's generic lanes: vmap of fit + evaluate over splits."""
    def one(tw, ew):
        return kernel.evaluate(kernel.fit(X, y, tw, {}, static), X, y, ew, static)

    out = jax.jit(jax.vmap(one))(jnp.asarray(TW), jnp.asarray(EW))
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_scores(kernel, X, y, TW, EW, static):
    out = kernel.batched_scores(torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(TW),
                                torch.as_tensor(EW), {"_pad": torch.zeros(1)}, static)
    return {k: v[0].numpy() for k, v in out.items()}


def _assert_scores_close(task, got, want, EW):
    assert got.keys() == want.keys()
    if task == "classification":
        rows = np.abs(got["score"] - want["score"]) * EW.sum(axis=1)
        assert rows.max() <= 2 + 1e-3, rows
        return
    for key in ("score", "mse"):
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], atol=1e-4 * scale, rtol=0)


def _plan(y, task, n_folds=3):
    p = build_split_plan(y, task=task, n_folds=n_folds, random_state=0)
    return p.train_w.astype(np.float32), p.eval_w.astype(np.float32)


@pytest.mark.parametrize("task", list(FAMILIES))
@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_generic_path_matches_jax(task, k, weights):
    X, y, c = _data(task)
    TW, EW = _plan(y, task)
    jkern, tkern = (cls() for cls in FAMILIES[task])
    static = _static(k, weights, len(y), c)
    got = _torch_scores(tkern, X, y, TW, EW, static)
    want = _jax_scores(jkern, jnp.asarray(X), jnp.asarray(y), TW, EW, static)
    _assert_scores_close(task, got, want, EW)


@pytest.mark.parametrize("task", list(FAMILIES))
@pytest.mark.parametrize("k,weights", [(5, "uniform"), (20, "distance")])
def test_kernel_path_matches_jax_interpret(task, k, weights, monkeypatch):
    """Both packages forced onto the fused top-k: B6's plain version here,
    the Pallas kernel in interpret mode there."""
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    monkeypatch.setattr(jk, "_use_pallas", lambda n: True)
    monkeypatch.setattr(pallas_knn, "knn_topk",
                        functools.partial(pallas_knn.knn_topk, interpret=True))
    X, y, c = _data(task, n=500, seed=1)
    TW, EW = _plan(y, task)
    jkern, tkern = (cls() for cls in FAMILIES[task])
    static = _static(k, weights, len(y), c)
    cuda_knn.reset_launches()
    got = _torch_scores(tkern, X, y, TW, EW, static)
    assert cuda_knn.LAUNCHES["knn_topk"] == 0  # CPU tensors: the plain version
    want = _jax_scores(jkern, jnp.asarray(X), jnp.asarray(y), TW, EW, static)
    _assert_scores_close(task, got, want, EW)


def test_kernel_and_generic_neighbours_agree():
    """The two searches find the same neighbours (ordered by distance, the
    lowest index first on ties) where no slot is empty."""
    X, y, c = _data("classification", n=700, seed=2)
    TW, _ = _plan(y, "classification")
    kern = tk.KNNClassifierKernel()
    params = kern.fit(torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(TW), {}, {})
    Q = torch.as_tensor(X[:300])
    for k in (5, 20):
        static = _static(k, "uniform", 700, c)
        gd, gi = kern._neighbors(params, Q, static)
        kd, ki = cuda_knn.knn_topk(Q, params["X"], params["w"], k)
        torch.testing.assert_close(gd, kd, rtol=1e-5, atol=1e-5)
        assert torch.equal(gi, ki)


@pytest.mark.parametrize("task", list(FAMILIES))
def test_chunked_protocol_matches_monolithic(task, monkeypatch):
    """Query-row chunks (the last one ragged, its start clamped) predict
    every row exactly as one dispatch does. The chunked run also draws the
    score-vs-chunk curve (an eval after the first chunk, then the final
    one), whose last point is each split's score."""
    X, y, c = _data(task, n=2000, seed=3)
    data = TrialData(X=X, y=y, n_classes=c)
    plan = build_split_plan(y, task=task, n_folds=3, random_state=0)
    kernel = tk.KNNClassifierKernel() if task == "classification" else tk.KNNRegressorKernel()
    params = [{"n_neighbors": 5}, {"n_neighbors": 20, "weights": "distance"}]
    cpu = torch.device("cpu")
    mono = trial_map.run_trials(kernel, data, plan, params, device=cpu)
    monkeypatch.setenv("CS230_KNN_CHUNK_MACS", "5e7")
    static = _static(5, "uniform", 2000, c)
    cp = kernel.chunked_plan(static, 2000, 8, c, plan.n_splits, device=cpu)
    assert cp == {"n_chunks": 2, "rows_per_chunk": 1024}, cp  # the last one ragged
    chunked = trial_map.run_trials(kernel, data, plan, params, device=cpu)
    for a, b in zip(mono.trial_metrics, chunked.trial_metrics):
        curve = b.pop("curve")
        assert a == b
        assert curve["stride"] == 1 and curve["steps"] == 2
        assert [row[-1] for row in curve["score"]] == curve["tail"]
        assert all(len(row) == 2 for row in curve["score"])


PLAN_TABLE = [  # (n, d, S, k)
    (3_500, 8, 4, 5), (116_202, 54, 6, 5), (116_202, 54, 6, 25), (150_000, 54, 6, 5),
    (170_000, 54, 6, 5), (180_000, 54, 6, 5), (187_500, 54, 5, 5), (200_000, 54, 6, 5),
    (200_000, 54, 6, 25), (581_012, 54, 6, 5), (60_000, 784, 6, 16), (150, 4, 6, 7),
]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_chunked_plan_matches_jax(device, monkeypatch):
    """``chunked_plan`` on the port's device equals the reference's on the
    matching backend: the CPU (no fused kernel) or an accelerator, where
    the gate opens at 150,000 training rows of a split."""
    if device == "cuda":  # what the reference's gate reads on a TPU backend
        monkeypatch.setattr(jk, "_use_pallas", lambda n: n >= jk._PALLAS_MIN_N)
    seen = set()
    for n, d, S, k in PLAN_TABLE:
        static = {"n_neighbors": k, "weights": "uniform", "p": 2}
        want = jk.KNNClassifierKernel().chunked_plan(static, n, d, 7, S)
        got = tk.KNNClassifierKernel().chunked_plan(static, n, d, 7, S,
                                                    device=torch.device(device))
        assert got == want, (n, d, S, k)
        seen.add(None if want is None else want["n_chunks"])
    assert None in seen and len(seen) > 3


def test_main_path_plan_makes_196_launches():
    """The slice's job on the card: 4 buckets of 49 query chunks of 4,096
    rows (the 2.5e11-MAC budget of the fused kernel's path)."""
    cuda = torch.device("cuda")
    kern = tk.KNNClassifierKernel()
    total = 0
    for k in (5, 25):
        static = kern.resolve_static({"n_neighbors": k, "weights": "uniform", "p": 2},
                                     200_000, 54, 7)
        plan = kern.chunked_plan(static, 200_000, 54, 7, 6, device=cuda)
        assert plan == {"n_chunks": 49, "rows_per_chunk": 4096}
        total += 2 * plan["n_chunks"]
    assert total == 196


def test_gate_and_static_resolution(monkeypatch):
    monkeypatch.delenv("CS230_FORCE_PACKED", raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not tk._use_pallas(149_999, cuda) and tk._use_pallas(150_000, cuda)
    assert not tk._use_pallas(10**6, cpu)
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    assert tk._use_pallas(10, cpu)
    for bad in ({"p": 1, "weights": "uniform"}, {"p": 2, "weights": "gaussian"}):
        for kern in (jk.KNNClassifierKernel(), tk.KNNClassifierKernel()):
            with pytest.raises(ValueError):
                kern.resolve_static(bad, 100, 4, 3)
    static = {"n_neighbors": 500, "weights": "distance", "p": 2}
    assert (tk.KNNRegressorKernel().resolve_static(static, 120, 4, 0)
            == jk.KNNRegressorKernel().resolve_static(static, 120, 4, 0))
    assert (tk.KNNClassifierKernel().memory_estimate_mb(5000, 54, static)
            == jk.KNNClassifierKernel().memory_estimate_mb(5000, 54, static))
    assert (tk.KNNClassifierKernel().macs_estimate(5000, 54, static)
            == jk.KNNClassifierKernel().macs_estimate(5000, 54, static))


def test_vote_weights_and_exact_matches_match_jax():
    """Distance weights 1/d, and a query with an exact match voted on by
    its exact matches only."""
    rng = np.random.RandomState(4)
    d2 = rng.rand(6, 5).astype(np.float32) * 4
    d2[1, 2] = 0.0
    d2[3, [0, 4]] = 0.0
    d2[4, 1] = -1e-7  # rounding below zero clamps to an exact match
    for weights in ("uniform", "distance"):
        static = {"weights": weights}
        want = np.asarray(jk._KNNBase._vote_weights(jnp.asarray(d2), static))
        got = tk._KNNBase._vote_weights(torch.as_tensor(d2), static).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_predictions_with_duplicates_and_ties_match_jax():
    """Duplicated training rows and integer features (exact distance ties)
    give the reference's labels and regression values on both paths."""
    rng = np.random.RandomState(5)
    base = rng.randint(-2, 3, (100, 3)).astype(np.float32)
    X = np.concatenate([base, base])
    y = rng.randint(0, 4, 200).astype(np.int32)
    w = (rng.rand(1, 200) > 0.3).astype(np.float32)
    for k, weights in ((5, "uniform"), (20, "distance")):
        static = {"n_neighbors": k, "weights": weights, "p": 2, "_n_classes": 4}
        for jcls, tcls in FAMILIES.values():
            jkern, tkern = jcls(), tcls()
            jp = jkern.fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w[0]), {}, static)
            want = np.asarray(jkern.predict(jp, jnp.asarray(X), static))
            tp = tkern.fit(torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(w), {}, static)
            got = tkern.predict(tp, torch.as_tensor(X), static)[0].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
