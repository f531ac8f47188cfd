"""The port's gradient boosting (models/trees.py) against the JAX package's,
on the CPU, fed the same numpy inputs.

Boosting's histograms carry float stats (gradients and hessians, or
residuals), and the two packages add their bin prefix sums in other orders
(XLA's triangular contraction against torch's cumsum), so a close call
(ops/tree_checks.py: a best gain within 1e-5 of the node's own term of
the next, of the split threshold, or of a candidate whose hessian sum sits
at min_samples_leaf) may go either way, and one flip compounds over the
stages. So stages are held one at a time, both packages starting from the
JAX package's F: every split equal but at close calls (the subtree below
one is not compared), every compared leaf value within 1e-5, and six
stages chained this way. The free-running fits are held by score: the
eval accuracy or r2 within 2e-3. The chunked protocol must give the
unchunked fit's scores to the bit, and ``chunked_plan`` the JAX plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.utils import prng
from cs230_distributed_machine_learning_tpu_torch.ops.tree_checks import check_tree

torch.set_num_threads(1)

N, D, L, STAGES, BINS, DEPTH = 400, 6, 2, 6, 32, 3
SCORE_TOL = 2e-3

# (kernel, classes, subsample, max_features)
CASES = {
    "gbc_binary": ("GradientBoostingClassifier", 2, 1.0, None),
    "gbc_binary_sub_mf": ("GradientBoostingClassifier", 2, 0.8, 3),
    "gbc_3class": ("GradientBoostingClassifier", 3, 1.0, None),
    "gbc_3class_sub_mf": ("GradientBoostingClassifier", 3, 0.8, 3),
    "gbr": ("GradientBoostingRegressor", 0, 1.0, None),
    "gbr_sub_mf": ("GradientBoostingRegressor", 0, 0.8, 3),
}


def _data(c, seed=0):
    """Rows, labels (c classes, or a float target at c = 0), fit and eval
    weights of L lanes (disjoint)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(np.float32)
    if c:
        y = np.argmax(X[:, :c] + 0.5 * rng.randn(N, c), axis=1).astype(np.int32)
    else:
        y = (2 * X[:, 0] - X[:, 1] ** 2 + rng.randn(N)).astype(np.float32)
    fit = (rng.rand(L, N) > 0.3).astype(np.float32)
    return X, y, fit, 1.0 - fit


def _kernels(case):
    name, c, sub, mf = CASES[case]
    jk = getattr(jmt, name + "Kernel")()
    tk = getattr(tmt, name + "Kernel")()
    params = {"n_estimators": STAGES, "max_depth": DEPTH, "random_state": 3, "n_bins": BINS}
    if mf:
        params["max_features"] = mf
    statics = []
    for k in (jk, tk):
        static = k.resolve_static(dict(params), N, D, c)
        static["_n_classes"] = c
        statics.append(static)
    lr = np.array([0.1, 0.3], np.float32)
    return jk, tk, statics[0], statics[1], c, np.full(L, sub, np.float32), lr


def _jax_stage(jk, js, xb, y):
    """The JAX stage, vmapped over the lanes' (w, lr, subsample, F)."""
    def one(w, lr, sub, F, key):
        return jk._stage(xb, y, w, {"learning_rate": lr, "subsample": sub}, js, F, key)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))


def _check_stage(tk, ts, xb, y, w, lr, sub, F, t, jF_new, jtrees, mf, c):
    """One port stage from the reference's F against the reference's."""
    key = prng.fold_in(prng.PRNGKey(ts["_seed"]), t)
    hyper = {"learning_rate": torch.as_tensor(lr), "subsample": torch.as_tensor(sub)}
    tw = torch.as_tensor(w)
    tF, ttree = tk._stage(torch.as_tensor(xb), torch.as_tensor(y), tw, hyper, ts,
                          torch.tensor(np.asarray(F)), key)
    sub_key, feat_key = prng.split(key).unbind(-2)
    S, C, keys = tk._stage_stats(torch.as_tensor(y), tk._subsample(sub_key, tw, hyper["subsample"]),
                                 torch.tensor(np.asarray(F)), ts, feat_key)
    kdim = S.shape[0] // L
    close = 0
    for lane in range(L * kdim):
        l, k = divmod(lane, kdim)
        jtree = {name: (v[l, k] if tk.task == "classification" else v[l])
                 for name, v in jtrees.items()}
        tkey = keys[lane] if keys.dim() == 2 else keys
        close += check_tree(xb, S[lane].numpy(), C[lane].numpy(), jtree,
                            {name: v[lane].numpy() for name, v in ttree.items()},
                            depth=DEPTH, n_bins=BINS, mf=mf, key=tkey)
    if not close:
        np.testing.assert_allclose(tF.numpy(), np.asarray(jF_new), rtol=1e-5, atol=1e-5)
    return close


def _score(task_c, y, F, ew):
    if task_c:
        pred = np.argmax(F, axis=-1)
        return ((pred == y[None]) * ew).sum(-1) / ew.sum(-1)
    ybar = (y[None] * ew).sum(-1, keepdims=True) / ew.sum(-1, keepdims=True)
    return 1 - (ew * (y[None] - F) ** 2).sum(-1) / (ew * (y[None] - ybar) ** 2).sum(-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_match_jax(case):
    """Six stages, each from the reference's F (tie-aware, as the module
    says), with the stage keys ``fold_in(PRNGKey(seed), t)``; then the
    free-running fits' eval scores within SCORE_TOL."""
    jk, tk, js, ts, c, sub, lr = _kernels(case)
    X, y, w, ew = _data(c)
    xb = np.array(jk.prepare_data(X, js)["xb"])
    np.testing.assert_array_equal(xb, tk.prepare_data(X, ts)["xb"])
    stage = _jax_stage(jk, js, jnp.asarray(xb), jnp.asarray(y))
    jprior = jax.vmap(lambda wl: jk._prior(jnp.asarray(y), wl, js))(jnp.asarray(w))
    jF = jax.vmap(lambda p: jk._f0(N, p, js))(jprior)
    tw = torch.as_tensor(w)
    tF0 = tk._f0(N, tk._prior(torch.as_tensor(y), tw, ts), ts)
    np.testing.assert_allclose(tF0.numpy(), np.asarray(jF), rtol=1e-6, atol=1e-7)
    base = jax.random.PRNGKey(js["_seed"])
    close = []
    for t in range(STAGES):
        jF_new, jtrees = stage(jnp.asarray(w), jnp.asarray(lr), jnp.asarray(sub), jF,
                               jax.random.fold_in(base, t))
        close.append(_check_stage(tk, ts, xb, y, w, lr, sub, jF, t, jF_new, jtrees,
                                  CASES[case][3], c))
        jF = jF_new
    hyper = {"learning_rate": torch.as_tensor(lr), "subsample": torch.as_tensor(sub)}
    tF = tk._stages(torch.as_tensor(xb), torch.as_tensor(y), tw, hyper, ts, tF0, range(STAGES))
    np.testing.assert_allclose(_score(c, y, tF.numpy(), ew), _score(c, y, np.asarray(jF), ew),
                               atol=SCORE_TOL)
    print(case, "close calls a stage:", close)


def test_constant_prior_stage_ties_are_the_only_differences():
    """The first stage of a 3-class fit starts from the constant prior, so
    each class's gradients take two values a row and many split gains tie
    exactly: the packages may break those ties apart, and everything else
    agrees."""
    jk, tk, js, ts, c, sub, lr = _kernels("gbc_3class")
    X, y, w, _ = _data(c, seed=1)
    xb = np.array(jk.prepare_data(X, js)["xb"])
    jprior = jax.vmap(lambda wl: jk._prior(jnp.asarray(y), wl, js))(jnp.asarray(w))
    jF = jax.vmap(lambda p: jk._f0(N, p, js))(jprior)
    jF_new, jtrees = _jax_stage(jk, js, jnp.asarray(xb), jnp.asarray(y))(
        jnp.asarray(w), jnp.asarray(lr), jnp.asarray(sub), jF,
        jax.random.fold_in(jax.random.PRNGKey(js["_seed"]), 0))
    _check_stage(tk, ts, xb, y, w, lr, sub, jF, 0, jF_new, jtrees, None, c)


def _trial_engine_inputs(case, n_trials=2):
    _, tk, _, ts, c, sub, _ = _kernels(case)
    X, y, w, ew = _data(c)
    Xp = {k: torch.as_tensor(v) for k, v in tk.prepare_data(X, ts).items()}
    hyper = {"learning_rate": torch.tensor([0.1, 0.4][:n_trials]),
             "subsample": torch.full((n_trials,), float(sub[0]))}
    return tk, ts, Xp, torch.as_tensor(y), torch.as_tensor(w), torch.as_tensor(ew), hyper


@pytest.mark.parametrize("case", ["gbc_3class_sub_mf", "gbc_binary", "gbr_sub_mf"])
def test_chunked_protocol_equals_unchunked_fit(case):
    """``chunk_init`` -> 3 x ``chunk_step`` of 2 stages -> ``chunk_eval`` on
    the lanes as ``_run_chunked`` lays them out gives ``batched_scores``'s
    scores to the bit."""
    tk, ts, X, y, TW, EW, hyper = _trial_engine_inputs(case)
    want = tk.batched_scores(X, y, TW, EW, hyper, ts)
    T, S = 2, TW.shape[0]
    plan = {"n_chunks": 3, "trees_per_chunk": 2}
    lanes = {k: v.repeat_interleave(S) for k, v in hyper.items()}
    state = tk.chunk_init(X, y, TW.repeat(T, 1), lanes, ts)
    for ci in range(plan["n_chunks"]):
        state = tk.chunk_step(X, y, TW.repeat(T, 1), lanes, ts, ci, state, plan)
    got = tk.chunk_eval(X, y, EW.repeat(T, 1), lanes, ts, state)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].reshape(T, S), want[k]), k


@pytest.mark.parametrize("name,n,d,c,n_estimators", [
    ("GradientBoostingRegressor", 867, 12, 0, 50),     # BASELINE config 4
    ("GradientBoostingRegressor", 867, 12, 0, 100),
    ("GradientBoostingClassifier", 116_202, 54, 7, 50),  # the chip's gb_main
    ("GradientBoostingClassifier", 3000, 54, 7, 50),
    ("GradientBoostingRegressor", 116_202, 54, 0, 100),
])
def test_chunked_plan_matches_jax(name, n, d, c, n_estimators):
    """The same stages a dispatch as the reference, from the same MAC
    estimate: config 4 is unchunked, gb_main 3 chunks of 17 stages."""
    jk, tk = getattr(jmt, name + "Kernel")(), getattr(tmt, name + "Kernel")()
    params = {"n_estimators": n_estimators, "random_state": 0}
    js, ts = (k.resolve_static(k.static_from_key(k.canonicalize(params)[0]), n, d, c)
              for k in (jk, tk))
    js["_n_classes"] = ts["_n_classes"] = c
    assert tk.macs_estimate(n, d, ts) == jk.macs_estimate(n, d, js)
    assert tk.chunked_plan(ts, n, d, c, 6) == jk.chunked_plan(js, n, d, c, 6)
    if (name, n) == ("GradientBoostingClassifier", 116_202):
        assert tk.chunked_plan(ts, n, d, c, 6) == {"n_chunks": 3, "trees_per_chunk": 17}
    if n == 867:
        assert tk.chunked_plan(ts, n, d, c, 6) is None
