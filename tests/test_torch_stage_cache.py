"""The port's stage cache (data/stage_cache.py) and its use by the trial
engine (parallel/trial_map.py::_Staging), on the CPU.

Single-flight staging under 8 threads, a failed make releasing its
waiters, LRU eviction, pins and a streamer's prefetch refs under memory
pressure, two tenants sharing block uploads, the CS230_STAGE_CACHE=0 valve
equal to the cached path to the bit, the strict budget, and the packed
LogReg path's staged extras (the padded bf16 design matrix and the
Lipschitz bound) staged once and equal to the inline derivation. Threads
are synchronised with barriers and events, never with sleeps.
"""

import threading

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu_torch.data import stage_cache as sc
from cs230_distributed_machine_learning_tpu_torch.data import streaming as st
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.obs import REGISTRY
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map as tm

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    for k in ("CS230_STAGE_CACHE", "CS230_STAGE_CACHE_MB", "CS230_STAGE_STRICT",
              "CS230_STREAM", "CS230_STREAM_BLOCK_ROWS"):
        monkeypatch.delenv(k, raising=False)
    sc.STAGE_CACHE.clear()
    yield
    sc.STAGE_CACHE.clear()


def _data(n=200, d=6, seed=0, dtype=np.float32, c=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(dtype)
    y = (X[:, 0] > 0).astype(np.int32) if c == 2 else rng.randint(0, c, n).astype(np.int32)
    return TrialData(X=X, y=y, n_classes=c)


def _mk(n=1000):
    return lambda: torch.zeros(n, dtype=torch.float32)  # 4 kB at n=1000


def test_single_flight_one_make_under_8_threads():
    made = []
    gate = threading.Event()
    barrier = threading.Barrier(9)  # the 8 jobs and this thread
    outcomes = []

    def make():
        made.append(1)
        assert gate.wait(10)  # held open until every thread passed the barrier
        return torch.zeros(16)

    def job():
        barrier.wait()
        outcomes.append(sc.STAGE_CACHE.get_or_stage(("fp", "dev", "X"), make)[1])

    threads = [threading.Thread(target=job) for _ in range(8)]
    for t in threads:
        t.start()
    barrier.wait()
    gate.set()
    for t in threads:
        t.join()
    assert len(made) == 1
    assert outcomes.count("miss") == 1 and set(outcomes) <= {"miss", "wait", "hit"}
    assert sc.STAGE_CACHE.stats()["uploads"] == 1
    assert sc.STAGE_CACHE.uploads_by_key() == {("fp", "dev", "X"): 1}


def test_failed_make_releases_waiters():
    inside, go = threading.Event(), threading.Event()
    calls, got = [], []

    def bad():
        calls.append("bad")
        inside.set()
        assert go.wait(10)
        raise RuntimeError("staging failed")

    def good():
        calls.append("good")
        return torch.ones(4)

    def first():
        with pytest.raises(RuntimeError):
            sc.STAGE_CACHE.get_or_stage(("k",), bad)

    a = threading.Thread(target=first)
    a.start()
    assert inside.wait(10)
    b = threading.Thread(target=lambda: got.append(sc.STAGE_CACHE.get_or_stage(("k",), good)))
    b.start()
    go.set()
    a.join()
    b.join()
    assert calls == ["bad", "good"]
    assert got[0][1] == "miss" and torch.equal(got[0][0], torch.ones(4))
    assert sc.STAGE_CACHE.stats()["uploads"] == 1


def test_lru_eviction_under_budget(monkeypatch):
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.01")  # 10 kB: two 4 kB entries
    for key in ("a", "b", "a", "c"):  # re-touching a refreshes it
        sc.STAGE_CACHE.get_or_stage((key,), _mk())
    assert sc.STAGE_CACHE.contains(("a",)) and sc.STAGE_CACHE.contains(("c",))
    assert not sc.STAGE_CACHE.contains(("b",))
    assert sc.STAGE_CACHE.stats()["evictions"] == 1
    assert sc.STAGE_CACHE.stats()["bytes"] == 8000


def test_pinned_entries_survive_pressure(monkeypatch):
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.008")
    token = sc.STAGE_CACHE.pin_begin()
    sc.STAGE_CACHE.get_or_stage(("pinned",), _mk())
    for key in ("lru", "new1", "new2"):
        sc.STAGE_CACHE.get_or_stage((key,), _mk())
    assert sc.STAGE_CACHE.contains(("pinned",))
    assert sc.STAGE_CACHE.stats()["pinned"] >= 1
    sc.STAGE_CACHE.pin_end(token)
    assert sc.STAGE_CACHE.stats()["pinned"] == 0
    sc.STAGE_CACHE.get_or_stage(("new3",), _mk())
    assert not sc.STAGE_CACHE.contains(("pinned",))


def test_strict_budget_raises_with_no_residue(monkeypatch):
    monkeypatch.setenv("CS230_STAGE_STRICT", "1")
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.1")
    before = REGISTRY.counter("tpuml_stage_cache_overflow_total").value()
    with pytest.raises(sc.StageBudgetExceeded):
        sc.STAGE_CACHE.get_or_stage(("fp", "dev", "huge"), _mk(200_000))
    stats = sc.STAGE_CACHE.stats()
    assert stats["entries"] == 0 and stats["bytes"] == 0 and stats["uploads"] == 0
    assert REGISTRY.counter("tpuml_stage_cache_overflow_total").value() == before + 1
    val, outcome = sc.STAGE_CACHE.get_or_stage(("fp", "dev", "huge"), _mk(8))
    assert outcome == "miss" and val.shape == (8,)


def test_fingerprint_keys_content_dtype_and_salt():
    a, b = _data(seed=3), _data(seed=3)
    assert sc.dataset_fingerprint(a) == sc.dataset_fingerprint(b)
    assert sc.dataset_fingerprint(_data(seed=4)) != sc.dataset_fingerprint(a)
    assert sc.dataset_fingerprint(_data(seed=3, dtype=np.float64)) != sc.dataset_fingerprint(a)
    salted = _data(seed=3)
    object.__setattr__(salted, "preprocess_salt", "scaler-v2")
    assert sc.dataset_fingerprint(salted) != sc.dataset_fingerprint(a)
    # the engine's keys carry the device's identity: a CPU entry never
    # serves a CUDA run, or the reverse
    assert tm._device_sig(torch.device("cpu")) == ("cpu", 0)
    assert tm._device_sig(torch.device("cuda", 1)) == ("cuda", 1)


def _streamer(arr, plan, **kw):
    return st.RowBlockStreamer(("fp", ("cpu", 0), "block", "t"), st.array_block_source(arr, plan),
                               plan, device=CPU, row_shape=arr.shape[1:], **kw)


def test_prefetch_ref_survives_pressure(monkeypatch):
    """While a pass runs, its in-flight and prefetched blocks hold refs: a
    tenant's burst between yields evicts only consumed blocks, so no block
    is uploaded twice within the pass and every yielded block is intact."""
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.3")
    arr = np.random.default_rng(1).normal(size=(2048, 16)).astype(np.float32)
    plan = st.plan_blocks(2048, row_bytes=64, rows=256)  # 16 kB blocks
    s = _streamer(arr, plan, double_buffer=True)
    for j, (i, start, blk) in enumerate(s.iter_blocks()):
        assert np.array_equal(blk.numpy(), arr[start:start + 256])
        sc.STAGE_CACHE.get_or_stage(("fp2", "dev", "junk", j), _mk(50_000))  # 200 kB
    assert s.stats["uploads"] == plan.n_blocks and s.stats["passes"] == 1
    assert sc.STAGE_CACHE.stats()["evictions"] > 0


@pytest.mark.parametrize("double_buffer", [True, False])
def test_streamed_blocks_stay_out_of_the_runs_pins(monkeypatch, double_buffer):
    """A run's pin scope takes no block it streams, with the prefetch
    worker or without: under a budget below a pass's blocks every pass
    uploads every block again, and the cache ends within its budget."""
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.05")
    arr = np.random.default_rng(3).normal(size=(2048, 16)).astype(np.float32)
    plan = st.plan_blocks(2048, row_bytes=64, rows=256)  # 8 blocks of 16 kB
    s = _streamer(arr, plan, double_buffer=double_buffer)
    token = sc.STAGE_CACHE.pin_begin()
    try:
        for _ in range(2):
            assert sum(float(blk.sum()) for _, _, blk in s.iter_blocks()) == pytest.approx(
                float(arr.sum(dtype=np.float64)), rel=1e-5)
        assert s.stats["uploads"] == 2 * plan.n_blocks
        assert sc.STAGE_CACHE.stats()["bytes"] <= sc.budget_bytes()
    finally:
        sc.STAGE_CACHE.pin_end(token)


def test_two_tenants_share_block_uploads():
    arr = np.random.default_rng(2).normal(size=(1024, 8)).astype(np.float32)
    plan = st.plan_blocks(1024, row_bytes=32, rows=256)
    barrier = threading.Barrier(2)
    sums = []

    def tenant():
        s = _streamer(arr, plan)
        barrier.wait()
        sums.append(sum(float(blk.sum()) for _, _, blk in s.iter_blocks()))

    threads = [threading.Thread(target=tenant) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(sums) == 2 and sums[0] == sums[1]
    uploads = sc.STAGE_CACHE.uploads_by_key()
    assert sorted(uploads) == [("fp", ("cpu", 0), "block", "t", i) for i in range(4)]
    assert set(uploads.values()) == {1}


@pytest.mark.parametrize("model,params", [
    ("LogisticRegression", [{"C": 1.0}, {"C": 0.1}]),
    ("RandomForestClassifier", [{"n_estimators": 3, "max_depth": 3, "n_bins": 16,
                                 "random_state": 1}]),
])
def test_cache_valve_is_bit_equal(monkeypatch, model, params):
    """CS230_STAGE_CACHE=0 (per-call staging) gives the cached path's
    metrics to the bit and stages nothing in the cache; a second cached run
    uploads nothing new, and nothing stays pinned after a run."""
    data = _data(n=300, c=3, seed=5)
    plan = build_split_plan(data.y, task="classification", n_folds=2)
    kernel = get_kernel(model)
    on = tm.run_trials(kernel, data, plan, params, device=CPU)
    uploads = sc.STAGE_CACHE.uploads_by_key()
    assert uploads and sc.STAGE_CACHE.stats()["pinned"] == 0
    again = tm.run_trials(kernel, _data(n=300, c=3, seed=5), plan, params, device=CPU)
    assert sc.STAGE_CACHE.uploads_by_key() == uploads
    monkeypatch.setenv("CS230_STAGE_CACHE", "0")
    off = tm.run_trials(kernel, data, plan, params, device=CPU)
    assert on.trial_metrics == again.trial_metrics == off.trial_metrics
    assert sc.STAGE_CACHE.uploads_by_key() == uploads


def test_logreg_staged_extras_once_and_equal_to_inline(monkeypatch):
    """CS230_FORCE_PACKED=1 (the packed path, B2's plain version on the
    CPU): the first run stages the padded bf16 A and the Lipschitz bound
    once each; a second run stages neither and scores the same to the
    bit, as does the packed fn called directly, which derives both inline."""
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    monkeypatch.setenv("CS230_CURVES", "0")
    rng = np.random.RandomState(3)
    data = TrialData(X=rng.randn(600, 7).astype(np.float32),
                     y=rng.randint(0, 3, 600).astype(np.int32), n_classes=3)
    plan = build_split_plan(data.y, task="classification", n_folds=3)
    kernel = get_kernel("LogisticRegression")
    resolve = kernel.resolve_static
    monkeypatch.setattr(kernel, "resolve_static",
                        lambda s, n, d, c: {**resolve(s, n, d, c), "_method": "nesterov"})
    params = [{"C": c, "max_iter": 15} for c in (0.1, 1.0)]

    def extras():
        return {k: v for k, v in sc.STAGE_CACHE.uploads_by_key().items()
                if "batched_extra" in k}

    first = tm.run_trials(kernel, data, plan, params, device=CPU)
    ups = extras()
    assert sorted(k[4] for k in ups) == ["_logreg_ab", "_logreg_lam_max"]
    assert set(ups.values()) == {1}
    second = tm.run_trials(kernel, data, plan, params, device=CPU)
    assert extras() == ups
    assert first.trial_metrics == second.trial_metrics

    static = kernel.bucket_static({**kernel.resolve_static(
        kernel.static_from_key(kernel.canonicalize(params[0])[0]), 600, 7, 3),
        "_n_classes": 3}, [kernel.canonicalize(p)[1] for p in params])
    fn = kernel.build_batched_fn(static=static, n=600, d=7, n_classes=3,
                                 n_splits=plan.n_splits, chunk=128, device=CPU)
    hyper = tm._hyper_batch([kernel.canonicalize(p)[1] for p in params], [0, 1],
                            sorted(kernel.hyper_defaults), 128, CPU)
    out = fn(torch.as_tensor(data.X), torch.as_tensor(data.y), torch.as_tensor(plan.train_w),
             torch.as_tensor(plan.eval_w), hyper)["score"][:2].numpy()
    assert [m["mean_cv_score"] for m in first.trial_metrics] == [
        float(np.mean(out[j, 1:])) for j in range(2)]


def test_unseeded_plans_never_share_fold_tensors(monkeypatch):
    """A plan built with random_state=None draws its own holdout and has no
    signature: two such runs over one dataset each score on their own plan
    (equal to per-call staging), and no fold tensor of theirs is cached."""
    data = _data(n=300, c=3, seed=5)
    kernel = get_kernel("LogisticRegression")
    plans = [build_split_plan(data.y, task="classification", n_folds=2, random_state=None)
             for _ in range(2)]
    assert plans[0].signature is None and plans[0].eval_w.tobytes() != plans[1].eval_w.tobytes()
    on = [tm.run_trials(kernel, data, p, [{"C": 1.0}], device=CPU).trial_metrics
          for p in plans]
    assert not [k for k in sc.STAGE_CACHE.uploads_by_key() if "folds" in k]
    monkeypatch.setenv("CS230_STAGE_CACHE", "0")
    off = [tm.run_trials(kernel, data, p, [{"C": 1.0}], device=CPU).trial_metrics
           for p in plans]
    assert on == off


def test_byte_and_entry_gauges_match_the_jax_cache(monkeypatch):
    """The ``tpuml_stage_cache_{bytes,entries}`` gauges: after one stage,
    one hit, one stage that evicts the first entry and ``clear``, the
    port's Prometheus lines for both equal those of the JAX package's
    cache fed the same sequence (4 kB entries under a 6 kB budget)."""
    from cs230_distributed_machine_learning_tpu.data import stage_cache as jax_sc
    from cs230_distributed_machine_learning_tpu.obs import REGISTRY as JAX_REGISTRY

    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.006")
    names = ("tpuml_stage_cache_bytes", "tpuml_stage_cache_entries")

    def lines(registry):
        return [ln for ln in registry.render().splitlines() if ln.startswith(names)]

    runs = []
    for cache, registry, make in (
            (sc.STAGE_CACHE, REGISTRY, _mk()),
            (jax_sc.StagedDatasetCache(), JAX_REGISTRY, lambda: np.zeros(1000, np.float32))):
        seen = []
        for key in ("A", "A", "B"):
            cache.get_or_stage(("fp", "dev", key), make)
            seen.append(lines(registry))
        assert not cache.contains(("fp", "dev", "A"))  # evicted by B
        cache.clear()
        seen.append(lines(registry))
        runs.append(seen)
    assert runs[0] == runs[1], runs
    one = ["tpuml_stage_cache_bytes 4000", "tpuml_stage_cache_entries 1"]
    assert runs[0] == [one, one, one, ["tpuml_stage_cache_bytes 0",
                                       "tpuml_stage_cache_entries 0"]]
