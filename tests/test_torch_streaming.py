"""The port's out-of-core streaming (data/streaming.py, the engine's
``_run_streamed``, the streamed LogReg and forest drivers,
``ops/trees.py::build_tree_streamed``) and chunked CSV ingest against the
JAX package's, on the CPU, fed the same numpy inputs.

Tolerances: the block-plan arithmetic is copied, so equal; the streamed
LogReg sums f32 partial gradients block by block, so within 2e-3 of the
JAX package's streamed run and of the port's single-shot run (the
PERF.md limit for LogReg); the streamed forest's histograms are integer
stats, so its scores and trees are equal to the bit to the JAX package's
streamed forest and to the port's single-shot path.
"""

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu.data import stage_cache as jsc
from cs230_distributed_machine_learning_tpu.data import streaming as jst
from cs230_distributed_machine_learning_tpu.models.base import TrialData as JTrialData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jget
from cs230_distributed_machine_learning_tpu.parallel.trial_map import run_trials as jrun
from cs230_distributed_machine_learning_tpu_torch.data import stage_cache as sc
from cs230_distributed_machine_learning_tpu_torch.data import streaming as st
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.obs import REGISTRY
from cs230_distributed_machine_learning_tpu_torch.ops import trees as tt
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import run_trials
from cs230_distributed_machine_learning_tpu_torch.utils import prng

torch.set_num_threads(1)
CPU = torch.device("cpu")
LOGREG_TOL = 2e-3


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("CS230_STREAM", "CS230_STREAM_BLOCK_ROWS", "CS230_STAGE_CACHE_MB",
              "CS230_STAGE_STRICT", "CS230_STREAM_DOUBLE_BUFFER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CS230_STAGE_CACHE", "1")
    sc.STAGE_CACHE.clear()
    jsc.STAGE_CACHE.clear()
    yield
    sc.STAGE_CACHE.clear()
    jsc.STAGE_CACHE.clear()


def _arrays(n=1500, d=128, c=7, seed=7):
    """d = 128 makes resolve_static pick nesterov ((d+1)*c > 512), the
    LogReg method with a streamed driver, at a CPU-friendly n."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, c))
    y = np.argmax(X @ W + rng.normal(scale=0.5, size=(n, c)), 1).astype(np.int32)
    return X, y, c


def _both(X, y, c):
    return TrialData(X=X, y=y, n_classes=c), JTrialData(X=X, y=y, n_classes=c)


def _cv(out):
    return [(m["accuracy"], tuple(m.get("cv_scores", ()))) for m in out.trial_metrics]


# ---------------- the block-plan arithmetic (copied) ----------------


@pytest.mark.parametrize("n,row_bytes,rows,env_rows,budget_mb", [
    (1000, 4, 256, None, None), (1000, 4, None, "100", None), (350, 4, None, "100", None),
    (116_202, 216, None, None, "20"), (116_202, 216, None, None, None), (7, 32, 1000, None, None),
    (5, 8, None, "junk", "0.001"),
])
def test_block_plan_arithmetic_matches_jax(monkeypatch, n, row_bytes, rows, env_rows, budget_mb):
    """plan_blocks, stream_mode, should_stream and host_block_set equal
    the JAX package's under the same valves (an explicit budget, or the
    8 GB assumption both packages make without a card), except that
    ``auto`` streams past the whole budget where JAX streams past half."""
    if env_rows is not None:
        monkeypatch.setenv("CS230_STREAM_BLOCK_ROWS", env_rows)
    if budget_mb is not None:
        monkeypatch.setenv("CS230_STAGE_CACHE_MB", budget_mb)
    else:
        # the JAX package asks its backend for a memory limit first
        monkeypatch.setattr(jst, "budget_bytes", lambda: int(0.4 * 8e9))
    p, jp = st.plan_blocks(n, row_bytes, rows), jst.plan_blocks(n, row_bytes, rows)
    assert (p.n, p.rows, p.n_blocks, p.n_pad) == (jp.n, jp.rows, jp.n_blocks, jp.n_pad)
    assert [p.size(i) for i in p.block_ids()] == [jp.size(i) for i in jp.block_ids()]
    assert sum(p.size(i) for i in p.block_ids()) == n
    for raw in ("0", "off", "false", "1", "force", "auto", "junk", None):
        if raw is None:
            monkeypatch.delenv("CS230_STREAM", raising=False)
        else:
            monkeypatch.setenv("CS230_STREAM", raw)
        assert st.stream_mode() == jst.stream_mode()
        budget = sc.budget_bytes()
        for nbytes in (1, n * row_bytes, int(0.75 * budget), budget + 1, 10**12):
            want = (nbytes > budget if st.stream_mode() == "auto"
                    else jst.should_stream(nbytes))
            assert st.should_stream(nbytes) == want
    for shards in (1, 3, 5, 8):
        sets = [st.host_block_set(p.n_blocks, shards, s) for s in range(shards)]
        assert sets == [jst.host_block_set(p.n_blocks, shards, s) for s in range(shards)]
        assert sorted(i for r in sets for i in r) == list(range(p.n_blocks))


# ---------------- streamed LogReg (f32 block sums) ----------------


def test_streamed_logreg_matches_jax_and_single_shot(monkeypatch):
    """CS230_STREAM=force with block rows not dividing n: every fold score
    and mean_cv_score within 2e-3 of the JAX package's streamed run and of
    the port's single-shot run, the holdout accuracy within one of its 300
    rows of JAX's (one row is 3.3e-3; the packages' single-shot drivers
    differ by that row too) and within 2e-3 of the single-shot run; one
    block entry a block; CS230_STREAM_DOUBLE_BUFFER=1 (the prefetch worker)
    gives the same bits."""
    X, y, c = _arrays()
    data, jdata = _both(X, y, c)
    plan = build_split_plan(y, task="classification", n_folds=2)
    kern, jkern = get_kernel("LogisticRegression"), jget("LogisticRegression")
    params = [{"C": 1.0, "max_iter": 20}, {"C": 0.1, "max_iter": 20}]

    monkeypatch.setenv("CS230_STREAM", "0")
    single = run_trials(kern, data, plan, params, device=CPU)
    monkeypatch.setenv("CS230_STREAM", "force")
    monkeypatch.setenv("CS230_STREAM_BLOCK_ROWS", "512")
    passes0 = REGISTRY.counter("tpuml_stream_passes_total").value()
    streamed = run_trials(kern, data, plan, params, device=CPU)
    jstreamed = jrun(jkern, jdata, plan, params)
    assert 1500 % 512
    block_keys = [k for k in sc.STAGE_CACHE.uploads_by_key() if "block" in k]
    assert len(block_keys) == 3
    assert REGISTRY.counter("tpuml_stream_passes_total").value() - passes0 == 31 + 20 + 1
    for ref, holdout_tol in ((single, LOGREG_TOL), (jstreamed, 1.0 / 300 + 1e-6)):
        for m0, m1 in zip(ref.trial_metrics, streamed.trial_metrics):
            assert abs(m0["accuracy"] - m1["accuracy"]) <= holdout_tol
            assert np.allclose(m0["cv_scores"], m1["cv_scores"], atol=LOGREG_TOL, rtol=0)
            assert abs(m0["mean_cv_score"] - m1["mean_cv_score"]) <= LOGREG_TOL
    monkeypatch.setenv("CS230_STREAM_DOUBLE_BUFFER", "1")
    sc.STAGE_CACHE.clear()
    assert _cv(run_trials(kern, data, plan, params, device=CPU)) == _cv(streamed)


# ---------------- streamed forest (integer stats: to the bit) ----------------


def test_streamed_forest_bit_equal_to_jax_and_single_shot(monkeypatch):
    X, y, c = _arrays(n=700, d=12, c=3)
    data, jdata = _both(X, y, c)
    plan = build_split_plan(y, task="classification", n_folds=2)
    kern, jkern = get_kernel("RandomForestClassifier"), jget("RandomForestClassifier")
    params = [{"n_estimators": 2, "max_depth": 3, "n_bins": 16, "max_features": 4,
               "random_state": 3}]
    monkeypatch.setenv("CS230_STREAM", "0")
    single = run_trials(kern, data, plan, params, device=CPU)
    monkeypatch.setenv("CS230_STREAM", "force")
    monkeypatch.setenv("CS230_STREAM_BLOCK_ROWS", "256")
    streamed = run_trials(kern, data, plan, params, device=CPU)
    jstreamed = jrun(jkern, jdata, plan, params)
    assert [k for k in sc.STAGE_CACHE.uploads_by_key() if "block" in k]
    assert len(data._prepared_cache) == 1  # the mode flip re-binned nothing
    assert _cv(streamed) == _cv(single) == _cv(jstreamed)


@pytest.mark.parametrize("seed,depth,max_features,rows", [
    (0, 1, None, 256), (1, 3, 4, 256), (2, 4, None, 100), (3, 5, 2, 700), (4, 3, 9, 333),
])
def test_build_tree_streamed_bit_equal_to_build_tree(seed, depth, max_features, rows):
    """Splits, leaf values, leaf weights and the final node ids equal to
    the bit (two lanes, bootstrap-like integer weights, pad rows at zero
    weight)."""
    rng = np.random.default_rng(seed)
    n, d, c, n_bins = 700, 9, 3, 16
    xb = rng.integers(0, n_bins, size=(n, d)).astype(np.int32)
    yv = rng.integers(0, c, size=(n,))
    w = rng.integers(0, 3, size=(2, n)).astype(np.float32)
    S = torch.nn.functional.one_hot(torch.as_tensor(yv), c).float()[None] * torch.as_tensor(w)[..., None]
    C = torch.as_tensor(w)
    key = prng.PRNGKey(11 + seed)
    common = dict(depth=depth, n_bins=n_bins, max_features=max_features, key=key,
                  count_from_stats=True)
    ref = tt.build_tree(torch.as_tensor(xb), S, C, **common)

    plan = st.plan_blocks(n, row_bytes=d * 4, rows=rows)
    pad = plan.n_pad - n
    xb_pad = np.concatenate([xb, np.zeros((pad, d), np.int32)])
    blocks = 0

    def stream_pass(fn, carry, *consts):
        nonlocal blocks
        for i in plan.block_ids():
            s = plan.start(i)
            carry = fn(carry, *consts, torch.as_tensor(xb_pad[s:s + plan.rows]), s)
            blocks += 1
        return carry

    tree, node = tt.build_tree_streamed(
        stream_pass, torch.nn.functional.pad(S, (0, 0, 0, pad)),
        torch.nn.functional.pad(C, (0, pad)), d, **common)
    for k in ("split_feat", "split_bin", "leaf_val", "leaf_weight"):
        assert torch.equal(tree[k], ref[k]), k
    leaf = tt._route(torch.as_tensor(xb), ref["split_feat"], ref["split_bin"], depth)
    assert torch.equal(node[:, :n] - (2**depth - 1), leaf)
    assert blocks == (depth + 1) * plan.n_blocks


# ---------------- the budget wall the streamer removes ----------------


@pytest.mark.parametrize("model,d,c,params", [
    ("LogisticRegression", 128, 7, [{"C": 1.0, "max_iter": 10}]),
    ("RandomForestClassifier", 32, 3, [{"n_estimators": 1, "max_depth": 3, "n_bins": 8,
                                        "random_state": 0}]),
])
def test_strict_budget_single_shot_raises_auto_completes(monkeypatch, model, d, c, params):
    """X (LogReg: 1500 x 128 f32, 768 kB; forest: the 1500 x 32 int32
    codes, 192 kB) over a 0.15 MB strict budget: CS230_STREAM=0 raises
    StageBudgetExceeded and leaves nothing staged; auto streams it."""
    monkeypatch.setenv("CS230_STAGE_STRICT", "1")
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.15")
    monkeypatch.setenv("CS230_STREAM_BLOCK_ROWS", "256")
    X, y, c = _arrays(n=1500, d=d, c=c)
    data = TrialData(X=X, y=y, n_classes=c)
    plan = build_split_plan(y, task="classification", n_folds=0)
    kern = get_kernel(model)
    monkeypatch.setenv("CS230_STREAM", "0")
    with pytest.raises(sc.StageBudgetExceeded):
        run_trials(kern, data, plan, params, device=CPU)
    stats = sc.STAGE_CACHE.stats()
    assert stats["pinned"] == 0 and not [k for k in sc.STAGE_CACHE.keys()
                                         if "X" in k or "prepared" in k]
    monkeypatch.setenv("CS230_STREAM", "auto")
    out = run_trials(kern, data, plan, params, device=CPU)
    assert len(out.trial_metrics) == 1 and 0.0 <= out.trial_metrics[0]["accuracy"] <= 1.0
    assert [k for k in sc.STAGE_CACHE.uploads_by_key() if "block" in k]


# ---------------- chunked CSV ingest ----------------


def test_csv_chunked_ingest_matches_jax(tmp_path):
    import pandas as pd

    from cs230_distributed_machine_learning_tpu.data import download as jdl
    from cs230_distributed_machine_learning_tpu.data import preprocess as jpp
    from cs230_distributed_machine_learning_tpu_torch.data import download as dl
    from cs230_distributed_machine_learning_tpu_torch.data import preprocess as pp

    rng = np.random.default_rng(6)
    n = 333
    df = pd.DataFrame({"a": rng.normal(2.0, 3.0, size=n), "b": rng.normal(-1.0, 0.5, size=n),
                       "z": np.zeros(n), "label": rng.integers(0, 2, size=n)})
    path = str(tmp_path / "toy.csv")
    df.to_csv(path, index=False)

    stats = pp.chunked_column_stats(dl.iter_csv_chunks(path, chunk_rows=50), columns=["a", "b", "z"])
    assert stats == jpp.chunked_column_stats(jdl.iter_csv_chunks(path, chunk_rows=50),
                                             columns=["a", "b", "z"])
    for col in ("a", "b"):
        assert stats[col]["count"] == n
        assert abs(stats[col]["mean"] - df[col].mean()) < 1e-9
        assert abs(stats[col]["std"] - df[col].std(ddof=0)) < 1e-9

    def opener(dlm, ppm):
        return lambda: ppm.iter_design_blocks(dlm.iter_csv_chunks(path, chunk_rows=50),
                                              stats=stats, target_column="label")

    plan = st.plan_blocks(n, row_bytes=12, rows=64)
    src = st.CsvBlockSource(opener(dl, pp), plan)
    jsrc = jst.CsvBlockSource(opener(jdl, jpp), jst.plan_blocks(n, row_bytes=12, rows=64))
    got = [src.fetch(i) for i in plan.block_ids()]
    assert all(np.array_equal(g, jsrc.fetch(i)) for i, g in enumerate(got))
    ref = np.stack([(df[col] - stats[col]["mean"]) / stats[col]["std"] for col in ("a", "b")]
                   + [np.zeros(n)], 1).astype(np.float32)
    assert np.allclose(np.concatenate([g[: plan.size(i)] for i, g in enumerate(got)]), ref,
                       atol=1e-6)
    # a rewind (a new pass) and a skip ahead (per-host block sets)
    assert np.array_equal(src.fetch(0), got[0])
    tail = plan.n_blocks - 1
    assert np.array_equal(src.fetch(tail), got[tail])
