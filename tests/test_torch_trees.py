"""The port's tree builders and forest pieces (ops/trees.py,
models/trees.py) against the JAX package's, on the CPU, fed the same numpy
inputs.

``build_tree`` and ``build_tree_deep`` take an explicit lane axis in the
port; the JAX builders are vmapped over the same lanes. Split records,
routing tables, leaf values and leaf weights must be EQUAL (integer stats:
every histogram is exact, and the split search follows the reference's
arithmetic and tie order), under bootstrap counts, random feature subsets
(``max_features``), feature groups, the adaptive bin schedule and the
width schedule. The predictions, the binning and the bootstrap draw are
held equal too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu.ops import trees as jt
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.ops import trees as tt
from cs230_distributed_machine_learning_tpu_torch.utils import prng

torch.set_num_threads(1)

N, D_CONT, D_BIN, K, L = 700, 4, 8, 3, 2


def _data(seed=0):
    """Rows with 4 continuous and 8 one-hot columns (so the deep builder's
    coarse group applies), 3 classes, and 2 lanes of fold weights."""
    rng = np.random.RandomState(seed)
    Xc = rng.randn(N, D_CONT).astype(np.float32)
    Xb = np.eye(D_BIN, dtype=np.float32)[rng.randint(0, D_BIN, N)]
    X = np.concatenate([Xc, Xb], axis=1)
    logits = Xc @ rng.randn(D_CONT, K) + Xb @ rng.randn(D_BIN, K)
    y = np.argmax(logits + 0.7 * rng.randn(N, K), axis=1).astype(np.int32)
    w = (rng.rand(L, N) > 0.25).astype(np.float32)
    return X, y, w


def _binned(X, n_bins):
    edges = jt.quantile_bins(X, n_bins)
    return edges, np.array(jt.bin_data(X, edges))


def test_binning_matches():
    X, _, _ = _data()
    for n_bins in (16, 48, 128):
        je, jx = _binned(X, n_bins)
        te = tt.quantile_bins(X, n_bins)
        np.testing.assert_array_equal(je, te)
        np.testing.assert_array_equal(jx, tt.bin_data(X, te).numpy())


def test_bootstrap_counts_match():
    """Per-lane active rows, one shared key: the same multinomial counts,
    including a lane with no active row."""
    _, _, w = _data()
    w = np.concatenate([w, np.zeros((1, N), np.float32)])
    key = jax.random.PRNGKey(4)
    want = jax.vmap(lambda wl: jmt._bootstrap_counts(key, wl, N))(jnp.asarray(w))
    got = tmt._bootstrap_counts(prng.PRNGKey(4), torch.as_tensor(w), N)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got[-1].sum() == 0


def _stats(y, w, seed):
    """Bootstrapped one-hot stats and counts [L, N, K], [L, N]."""
    counts = np.array(jax.vmap(
        lambda wl: jmt._bootstrap_counts(jax.random.PRNGKey(seed), wl, N))(jnp.asarray(w)))
    S = np.eye(K, dtype=np.float32)[y][None] * counts[..., None]
    return S, counts


def _assert_trees_equal(jtree, ttree):
    assert set(ttree) == set(jtree)
    for name in jtree:
        np.testing.assert_array_equal(np.asarray(jtree[name]), ttree[name].numpy(),
                                      err_msg=name)


COMPLETE = {
    "plain": dict(),
    "max_features": dict(max_features=2),
}


@pytest.mark.parametrize("case", sorted(COMPLETE))
def test_build_tree_matches(case):
    X, y, w = _data(1)
    _, xb = _binned(X, 16)
    S, C = _stats(y, w, 7)
    kw = dict(depth=5, n_bins=16, min_samples_leaf=1.0, count_from_stats=True,
              **COMPLETE[case])
    jfit = jax.jit(jax.vmap(
        lambda s, c: jt.build_tree(jnp.asarray(xb), s, c, key=jax.random.PRNGKey(3),
                                   precision=None, **kw)))
    jtree = jfit(jnp.asarray(S), jnp.asarray(C))
    ttree = tt.build_tree(torch.as_tensor(xb), torch.as_tensor(S), torch.as_tensor(C),
                          key=prng.PRNGKey(3), **kw)
    _assert_trees_equal(jtree, ttree)
    jpred = jax.vmap(lambda tr: jt.predict_tree(jnp.asarray(xb), tr, 5, 16))(jtree)
    np.testing.assert_array_equal(
        np.asarray(jpred), tt.predict_tree(torch.as_tensor(xb), ttree, 5, 16).numpy())


DEEP = {
    "plain": dict(),
    "max_features_groups": dict(max_features=4, groups=True),
    "nb_schedule": dict(nb_schedule=(8, 4)),
    "w_schedule": dict(w_schedule=(8, 3, 4), max_features=6),
}


@pytest.mark.parametrize("case", sorted(DEEP))
def test_build_tree_deep_matches(case):
    X, y, w = _data(2)
    opts = dict(DEEP[case])
    use_groups = opts.pop("groups", False)
    edges, xb = _binned(X, 16)
    S, C = _stats(y, w, 11)
    groups_np = None
    if use_groups:
        prep = tmt.RandomForestClassifierKernel().prepare_data(X, {"_n_bins": 16, "_deep": True})
        assert "xb_coarse" in prep and prep["xb_coarse"].shape[1] == D_BIN
        groups_np = {g: prep[g] for g in ("xb_cont", "xb_coarse", "fid_cont", "fid_coarse")}
    kw = dict(levels=6, width=8, n_bins=16, min_samples_leaf=1.0, count_from_stats=True,
              **opts)
    jgroups = None if groups_np is None else {g: jnp.asarray(v) for g, v in groups_np.items()}
    jfit = jax.jit(jax.vmap(
        lambda s, c: jt.build_tree_deep(jnp.asarray(xb), s, c, key=jax.random.PRNGKey(5),
                                        precision=None, groups=jgroups, **kw)))
    jtree = jfit(jnp.asarray(S), jnp.asarray(C))
    tgroups = None if groups_np is None else {g: torch.as_tensor(v) for g, v in groups_np.items()}
    ttree = tt.build_tree_deep(torch.as_tensor(xb), torch.as_tensor(S), torch.as_tensor(C),
                               key=prng.PRNGKey(5), groups=tgroups, **kw)
    _assert_trees_equal(jtree, ttree)
    # the port's routing-table walk gives the reference's leaves, by its
    # routing tables and by its arena-table walk
    via_levels = tt.predict_tree_deep(torch.as_tensor(xb), ttree, 6, 16)
    jpredict = jax.vmap(lambda tr: jt.predict_tree_deep(jnp.asarray(xb), tr, 6, 16))
    arena_only = {k: jtree[k] for k in ("feat", "bin", "child", "leaf_val")}
    np.testing.assert_array_equal(np.asarray(jpredict(jtree)), via_levels.numpy())
    np.testing.assert_array_equal(np.asarray(jpredict(arena_only)), via_levels.numpy())


@pytest.mark.parametrize("n", [150, 3000, 11_620, 58_000, 116_202])
def test_resolve_static_and_chunk_plan_match(n):
    """Depth, arena width and schedules, bins, max_features, and the chunk
    plan of the forest at the scaling curve's sizes (covertype's 54
    features, 7 classes, 6 splits)."""
    jk, tk = jmt.RandomForestClassifierKernel(), tmt.RandomForestClassifierKernel()
    static = {"n_estimators": 100, "random_state": 42}
    js = jk.resolve_static(dict(static), n, 54, 7)
    ts = tk.resolve_static(dict(static), n, 54, 7)
    assert js == ts
    ts["_n_classes"] = js["_n_classes"] = 7
    assert jk.chunked_plan(js, n, 54, 7, 6) == tk.chunked_plan(ts, n, 54, 7, 6)


def test_trials_of_one_bucket_share_the_forest():
    """A bucket of forest trials (no traced hypers) runs as one
    ``batched_scores`` call over trials x splits lanes: each trial scores
    as it does alone."""
    from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import run_trials

    X, y, _ = _data(3)
    data = TrialData(X=X, y=y, n_classes=K)
    plan = build_split_plan(y, task="classification", n_folds=3)
    kernel = tmt.RandomForestClassifierKernel()
    cpu = torch.device("cpu")
    alone = run_trials(kernel, data, plan, [{"n_estimators": 2}], device=cpu)
    both = run_trials(kernel, data, plan, [{"n_estimators": 2}, {"n_estimators": 2, "n_jobs": 4}],
                      device=cpu)
    assert [m["cv_scores"] for m in both.trial_metrics] == [alone.trial_metrics[0]["cv_scores"]] * 2
