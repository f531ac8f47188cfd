"""The PyTorch port's LogisticRegression kernel (models/logistic.py) against
the JAX package's, on the CPU, fed the same numpy inputs.

- The packed path (``build_batched_fn``): the port's packed fn, which runs
  the CUDA kernels' plain versions here, against the JAX packed fn with the
  Pallas kernels in interpret mode, in both the fused (``pallas``) and
  ``legacy`` scan bodies.
- The generic drivers (``_nesterov`` under every ``CS230_MASKED_GRAD``
  mode, ``_newton`` on iris) through both trial engines.

Score tolerance: atol 2e-3. Against the Pallas kernels in interpret mode
the packed path is held by a count of eval rows instead: the Pallas kernel
rounds the gradient residual to bf16 and the plain version keeps it in f32
(the JAX reference's choice), so a few borderline eval rows flip between
the two. A lane's score times its eval-row count is its count of correct
rows; per lane the two may differ by at most 2 rows, and over all lanes by
at most 1 row in 1,000 lane-eval rows (measured: 32 rows over 384 lanes at
7 classes, 42 at 3 classes, of ~134,000).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.models.base import TrialData as JData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jax_tm
from cs230_distributed_machine_learning_tpu_torch.models import logistic as tlog
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData as TData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel as torch_kernel
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map as torch_tm

CPU = torch.device("cpu")

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)


def _packed_inputs(n, d, c, S, chunk, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    wt = rng.randn(d, c).astype(np.float32)
    y = np.argmax(X @ wt + 0.5 * rng.randn(n, c), axis=1).astype(np.int32)
    TW = (rng.rand(S, n) > 0.3).astype(np.float32)
    EW = (rng.rand(S, n) > 0.5).astype(np.float32)
    hyper = {
        "C": np.geomspace(0.05, 5.0, chunk).astype(np.float32),
        "max_iter": np.where(np.arange(chunk) % 2, 60.0, 3.0).astype(np.float32),
        "tol": np.full(chunk, 1e-4, np.float32),
    }
    return X, y, TW, EW, hyper


def _plain_pallas(monkeypatch):
    """Route the JAX packed fn through its kernels' ``*_reference``
    functions, the algebra the port's plain versions mirror."""
    from cs230_distributed_machine_learning_tpu.ops import pallas_logreg as jpl

    def plain(ref):
        return lambda *a, bm=256, interpret=False, **k: ref(*a, **k)

    monkeypatch.setattr(jpl, "packed_nesterov_step", plain(jpl.packed_nesterov_step_reference))
    monkeypatch.setattr(jpl, "packed_softmax_grad", plain(jpl.packed_softmax_grad_reference))


#: eval rows whose correctness may differ from the Pallas interpret run:
#: in one lane, and per 1,000 lane-eval rows over all lanes
MAX_ROWS_PER_LANE = 2
MAX_ROWS_PER_1000 = 1


@pytest.mark.parametrize("mode,c,fit_intercept,jax_route", [
    ("pallas", 7, True, "interpret"),
    ("pallas", 3, True, "interpret"),
    ("legacy", 3, False, "reference"),
])
def test_packed_fn_matches_jax(monkeypatch, mode, c, fit_intercept, jax_route):
    """Port packed fn vs JAX packed fn at n=700, d=5, S=3, chunk=128, 12
    steps, per-trial max_iter below the step cap: the fused body against
    the Pallas fused step in interpret mode (7 and 3 classes), the legacy
    body against the JAX kernels' plain references. Against the references
    every score is within atol 2e-3; against the Pallas kernels, which round
    the residual to bf16, by the count of eval rows (module docstring)."""
    n, d, S, chunk, steps = 700, 5, 3, 128, 12
    monkeypatch.setenv("CS230_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    monkeypatch.setenv("CS230_FUSED_STEP", mode)
    if jax_route == "reference":
        _plain_pallas(monkeypatch)
    jax.clear_caches()
    static = {"fit_intercept": fit_intercept, "penalty": "l2",
              "_method": "nesterov", "_n_classes": c, "_iters": steps}
    X, y, TW, EW, hyper = _packed_inputs(n, d, c, S, chunk)

    jfn = jax_kernel("LogisticRegression").build_batched_fn(
        static=static, n=n, d=d, n_classes=c, n_splits=S, chunk=chunk)
    jout = jfn(jnp.asarray(X), jnp.asarray(y), jnp.asarray(TW), jnp.asarray(EW),
               {k: jnp.asarray(v) for k, v in hyper.items()})
    tfn = torch_kernel("LogisticRegression").build_batched_fn(
        static=static, n=n, d=d, n_classes=c, n_splits=S, chunk=chunk, device=CPU)
    tout = tfn(torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(TW),
               torch.as_tensor(EW), {k: torch.as_tensor(v) for k, v in hyper.items()})

    js, ts = np.asarray(jout["score"]), tout["score"].numpy()
    assert ts.shape == (chunk, S)
    diff = np.abs(ts - js)
    if jax_route == "reference":
        assert diff.max() <= 2e-3
    else:
        n_eval = EW.sum(axis=1)[None, :]  # [1, S] eval rows of each lane
        rows = diff * n_eval
        assert np.abs(rows - np.rint(rows)).max() < 1e-3  # whole rows
        rows = np.rint(rows)
        assert rows.max() <= MAX_ROWS_PER_LANE
        assert rows.sum() <= MAX_ROWS_PER_1000 * (chunk * n_eval.sum()) / 1000
    jc, tc = np.asarray(jout["curve_gmax"]), tout["curve_gmax"].numpy()
    assert tc.shape == jc.shape == (chunk, S, steps)
    assert np.abs(tc - jc).max() / np.abs(jc).max() < 1e-2


def _toy(n=600, d=9, c=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, c).astype(np.float32)
    y = np.argmax(X @ w + 0.5 * rng.randn(n, c), axis=1).astype(np.int32)
    return X, y, c


def _run(monkeypatch, engine, X, y, c, params, n_folds, method=None):
    """The trials through one engine ("jax" or "torch"), generic path (no
    packed valve), optionally forcing the solver."""
    monkeypatch.delenv("CS230_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("CS230_FORCE_PACKED", raising=False)
    plan = build_split_plan(y, task="classification", n_folds=n_folds)
    if engine == "jax":
        kernel, data = jax_kernel("LogisticRegression"), JData(X, y, c)
        run = lambda: jax_tm.run_trials(kernel, data, plan, params)  # noqa: E731
    else:
        kernel, data = torch_kernel("LogisticRegression"), TData(X, y, c)
        run = lambda: torch_tm.run_trials(kernel, data, plan, params, device=CPU)  # noqa: E731
    if method is not None:
        orig = kernel.resolve_static
        monkeypatch.setattr(kernel, "resolve_static",
                            lambda s, n, d, cc, o=orig: {**o(s, n, d, cc), "_method": method})
    return run().trial_metrics


def _run_both(monkeypatch, X, y, c, params, n_folds, method=None):
    return [_run(monkeypatch, e, X, y, c, params, n_folds, method) for e in ("jax", "torch")]


_NESTEROV_PARAMS = [{"C": c, "tol": 1e-4, "max_iter": 60} for c in [0.01, 0.1, 1.0, 10.0]]


@pytest.fixture(scope="module")
def jax_nesterov_metrics():
    """The JAX generic engine's default formulation, run once for every
    masked-gradient mode of the port."""
    X, y, c = _toy()
    with pytest.MonkeyPatch.context() as mp:
        return _run(mp, "jax", X, y, c, _NESTEROV_PARAMS, 3, method="nesterov")


@pytest.mark.parametrize("mode", ["auto", "xla", "legacy", "pallas"])
def test_generic_nesterov_matches_jax(monkeypatch, jax_nesterov_metrics, mode):
    """The lane-batched nesterov driver under each masked-gradient mode
    ("pallas" runs the lane kernel's plain version here) vs the JAX
    generic engine's default formulation."""
    monkeypatch.setenv("CS230_MASKED_GRAD", mode)
    X, y, c = _toy()
    tm = _run(monkeypatch, "torch", X, y, c, _NESTEROV_PARAMS, 3, method="nesterov")
    for a, b in zip(jax_nesterov_metrics, tm):
        assert b["mean_cv_score"] == pytest.approx(a["mean_cv_score"], abs=2e-3)
        assert b["accuracy"] == pytest.approx(a["accuracy"], abs=2e-3)
        assert b["curve"]["steps"] == a["curve"]["steps"] == 60


def test_generic_newton_on_iris_matches_jax(monkeypatch):
    from sklearn.datasets import load_iris

    bunch = load_iris()
    X, y = bunch.data.astype(np.float32), bunch.target.astype(np.int32)
    params = [{"C": c, "max_iter": 100} for c in [0.01, 0.1, 1.0, 10.0, 100.0]]
    jm, tm = _run_both(monkeypatch, X, y, 3, params, 5)
    for a, b in zip(jm, tm):
        assert b["mean_cv_score"] == pytest.approx(a["mean_cv_score"], abs=2e-3)
        np.testing.assert_allclose(b["cv_scores"], a["cv_scores"], atol=2e-3)
    best = lambda ms: int(np.argmax([m["mean_cv_score"] for m in ms]))  # noqa: E731
    assert best(jm) == best(tm)


def test_lipschitz_bound_matches_jax():
    from cs230_distributed_machine_learning_tpu.models.logistic import _packed_lam_max

    rng = np.random.RandomState(5)
    A = rng.randn(512, 64).astype(np.float32)
    TW = (rng.rand(3, 512) > 0.4).astype(np.float32)
    want = np.asarray(_packed_lam_max(jnp.asarray(A), jnp.asarray(TW)))
    got = tlog._lam_max(torch.as_tensor(A), torch.as_tensor(TW)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_packed_gate_routes_like_the_reference(monkeypatch):
    """batched_applicable: newton never; nesterov on the card at n >= 4096
    or when forced; the wide-feature bucket (784 features) goes to the
    generic drivers, as in the JAX package."""
    monkeypatch.delenv("CS230_FORCE_PACKED", raising=False)
    k = torch_kernel("LogisticRegression")
    cuda = torch.device("cuda")
    nest = {"_method": "nesterov", "_n_classes": 7, "fit_intercept": True}
    assert k.batched_applicable(nest, 116_202, 54, cuda)
    assert not k.batched_applicable(nest, 116_202, 54, CPU)
    assert not k.batched_applicable(nest, 1000, 54, cuda)
    assert not k.batched_applicable({**nest, "_method": "newton"}, 116_202, 54, cuda)
    assert not k.batched_applicable({**nest, "_n_classes": 10}, 60_000, 784, cuda)
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    assert k.batched_applicable(nest, 700, 5, CPU)
