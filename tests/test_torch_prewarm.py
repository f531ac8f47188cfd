"""The port's prewarm (runtime/prewarm.py, a copy; ``LocalExecutor.
prewarm_hint``; ``Coordinator.prewarm_hints``; utils/aot_cache.py) against
the JAX package, on the CPU: the hints derived from the same jobs and the
same predictor state equal JAX's; the worker yields to real work and never
warms a shape twice; ``CS230_PREWARM=0`` turns the path off in both
packages alike; a construct-mode warm stages what the real batch then hits
(no staging upload, no dispatch); the ``/subscribe`` handshake ships the
hints and the agent starts its warmer from them.
"""

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu.runtime import prewarm as jpw
from cs230_distributed_machine_learning_tpu_torch.runtime import prewarm as tpw
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


class _FakeExecutor:
    """Records prewarm_hint calls; ``busy`` is set by the test."""

    def __init__(self):
        self.busy = False
        self.calls = []

    def prewarm_hint(self, hint, mode="construct"):
        self.calls.append((hint["model_type"], mode))
        return {"model_type": hint["model_type"], "dataset_id": hint.get("dataset_id"),
                "n_trials": hint.get("n_trials", 1), "mode": mode, "compile_s": 0.0,
                "stage_s": 0.0}


def _hint(family="LogisticRegression", dataset="d1", n=4):
    return {"model_type": family, "dataset_id": dataset, "parameters": {}, "n_trials": n,
            "train_params": {}}


@pytest.mark.parametrize("pw", [tpw, jpw], ids=["torch", "jax"])
def test_worker_yields_to_real_work_and_never_warms_twice(pw):
    ex = _FakeExecutor()
    ex.busy = True
    worker = pw.PrewarmWorker(ex, [_hint(), dict(_hint()), _hint("GaussianNB")],
                              yield_poll_s=0.01, limit=10)
    worker.start()
    assert not worker.join(0.15) and not ex.calls  # a live batch owns the device
    ex.busy = False
    assert worker.join(5.0)
    assert [c[0] for c in ex.calls] == ["LogisticRegression", "GaussianNB"]


@pytest.mark.parametrize("raw,mode", [("0", "off"), ("off", "off"), ("1", "construct"),
                                      ("execute", "execute"), ("yes", "construct")])
def test_prewarm_valve_matches_jax(monkeypatch, raw, mode):
    monkeypatch.setenv("CS230_PREWARM", raw)
    assert tpw.prewarm_mode() == jpw.prewarm_mode() == mode
    ex = _FakeExecutor()
    worker = tpw.PrewarmWorker(ex, [_hint()])
    worker.start()
    assert worker.join(2.0)
    assert bool(ex.calls) == (mode != "off")


def _stage(name, n=300, d=5):
    """The same (X, y) staged in both packages' storage roots."""
    from cs230_distributed_machine_learning_tpu.data.datasets import stage_arrays as jstage
    from cs230_distributed_machine_learning_tpu_torch.data.datasets import stage_arrays

    rng = np.random.RandomState(0)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    stage_arrays(name, X, y)
    jstage(name, X, y)
    return name


def _jobs(coord, dataset):
    """Two finished jobs of two families on ``dataset``, the second with a
    non-scalar train param (filtered from hints)."""
    for details, tp in (
        ({"model_type": "GaussianNB", "parameters": {}},
         {"cv": 2, "test_size": 0.2, "random_state": 0}),
        ({"model_type": "LogisticRegression", "search_type": "GridSearchCV",
          "base_estimator_params": {"max_iter": 30}, "param_grid": {"C": [0.5, 2.0]}},
         {"cv": 3, "random_state": 1, "cv_list_like": [1, 2]}),
    ):
        sid = coord.create_session()
        out = coord.submit_train(sid, {"dataset_id": dataset, "model_details": details,
                                       "train_params": tp})
        coord.wait_for_completion(sid, out["job_id"], 120)


def _feed(predictor, families):
    for fam in families:
        predictor.observe({"model_type": fam}, 1.0)


@pytest.mark.parametrize("observed", [[], ["GaussianNB"] * 3 + ["LogisticRegression"],
                                      ["LogisticRegression"] * 2 + ["SVC"]])
def test_prewarm_hints_match_jax(observed):
    """The same jobs and the same predictor observations: the hint list
    (shapes, ranking, filtering, the limit) equals the JAX coordinator's."""
    from cs230_distributed_machine_learning_tpu.runtime.cluster import ClusterRuntime as JCluster
    from cs230_distributed_machine_learning_tpu.runtime.coordinator import Coordinator as JCoord
    from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    dataset = _stage("pwhints")
    tc, jc = Coordinator(device="cpu"), JCoord()
    assert tc.prewarm_hints() == jc.prewarm_hints() == []
    _jobs(tc, dataset)
    _jobs(jc, dataset)
    for limit in (None, 1):
        assert tc.prewarm_hints(limit=limit) == jc.prewarm_hints(limit=limit)
    # the ranking by the placement engine's hot families, on fresh
    # clustered coordinators fed the same observations
    tcl, jcl = ClusterRuntime(), JCluster()
    try:
        tcc = Coordinator(cluster=tcl, device="cpu")
        jcc = JCoord(cluster=jcl)
        tcc.store, jcc.store = tc.store, jc.store
        _feed(tcl.engine.predictor, observed)
        _feed(jcl.engine.predictor, observed)
        assert tcl.engine.hot_families() == jcl.engine.hot_families()
        got, want = tcc.prewarm_hints(), jcc.prewarm_hints()
        assert got == want and len(got) == 2
    finally:
        tcl.shutdown()
        jcl.shutdown()


def test_prewarm_hints_valve_and_overload(monkeypatch):
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    dataset = _stage("pwvalve")
    coord = Coordinator(device="cpu")
    _jobs(coord, dataset)
    assert len(coord.prewarm_hints()) == 2
    monkeypatch.setenv("CS230_PREWARM_MAX_HINTS", "1")
    assert len(coord.prewarm_hints()) == 1
    monkeypatch.setenv("CS230_PREWARM", "0")
    assert coord.prewarm_hints() == []
    monkeypatch.setenv("CS230_PREWARM", "1")
    monkeypatch.setattr(coord, "overload_shedding", lambda: True)
    assert coord.prewarm_hints() == []


def test_construct_warm_stages_what_the_real_batch_hits():
    """A construct-mode warm dispatches nothing and stages the dataset, the
    fold tensors and the packed path's forms; the real batch then stages
    nothing (its staging seconds are 0); the hint's trial count is capped
    at the executor's batch cap; execute mode dispatches."""
    from cs230_distributed_machine_learning_tpu_torch.data import stage_cache
    from cs230_distributed_machine_learning_tpu_torch.runtime.executor import LocalExecutor

    dataset = _stage("pwwarm", n=400)
    stage_cache.STAGE_CACHE.clear()
    ex = LocalExecutor(torch.device("cpu"), max_trials_per_batch=4)
    tp = {"cv": 3, "random_state": 0}
    hint = {"model_type": "LogisticRegression", "dataset_id": dataset,
            "parameters": {"C": 1.0, "max_iter": 30}, "n_trials": 1000, "train_params": tp}
    summary = ex.prewarm_hint(hint)
    assert summary["mode"] == "construct" and summary["n_dispatches"] == 0
    assert summary["n_trials"] == 4 and summary["stage_s"] > 0.0
    uploads = stage_cache.STAGE_CACHE.stats()["uploads"]
    seen = []
    ex.run_subtasks([{"subtask_id": f"s{i}", "job_id": "j", "dataset_id": dataset,
                      "model_type": "LogisticRegression",
                      "parameters": {"C": float(c), "max_iter": 30}, "train_params": tp}
                     for i, c in enumerate((0.5, 1.0, 2.0))],
                    on_metrics=lambda m: seen.append(m))
    primary = [m for m in seen if m.get("batch_primary")]
    assert primary and primary[0]["batch_stage_s"] == 0.0
    assert primary[0]["batch_compile_s"] == 0.0
    assert stage_cache.STAGE_CACHE.stats()["uploads"] == uploads
    assert ex.prewarm_hint(hint, mode="execute")["n_dispatches"] >= 1


def test_subscribe_ships_hints_and_the_agent_warms_them(monkeypatch):
    """The register -> hint handshake over HTTP: a worker subscribing after
    a job ran receives its shape; the agent starts a PrewarmWorker from it
    (none with the valve off) and the warm completes."""
    from cs230_distributed_machine_learning_tpu_torch.runtime.agent import WorkerAgent
    from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
    from cs230_distributed_machine_learning_tpu_torch.runtime.server import start_server

    dataset = _stage("pwrest")
    cluster = ClusterRuntime()
    coord = Coordinator(cluster=cluster, device="cpu")
    srv, _ = start_server(coord)
    agents = []
    try:
        cold = WorkerAgent(srv.url, device="cpu", poll_timeout_s=0.5)
        agents.append(cold)
        assert cold._prewarm_hints == []
        cluster.add_executor(device="cpu")
        _jobs(coord, dataset)
        warm = WorkerAgent(srv.url, device="cpu", poll_timeout_s=0.5)
        agents.append(warm)
        assert [(h["model_type"], h["dataset_id"]) for h in warm._prewarm_hints] == [
            (h["model_type"], h["dataset_id"]) for h in coord.prewarm_hints()]
        warm.start()
        assert warm._prewarm is not None and warm._prewarm.join(60)
        assert {r["model_type"] for r in warm._prewarm.results} == {
            "GaussianNB", "LogisticRegression"}
        monkeypatch.setenv("CS230_PREWARM", "0")
        off = WorkerAgent(srv.url, device="cpu", poll_timeout_s=0.5)
        agents.append(off)
        off.start()
        assert off._prewarm_hints == [] and off._prewarm is None
    finally:
        for a in agents:
            a.stop()
        srv.shutdown()
        srv.server_close()
        cluster.shutdown()


def test_aot_cache_inventory_and_prune(tmp_path, monkeypatch):
    """The port's persistent artifacts are the kernel libraries: the
    inventory counts the current generation's, pruning removes only
    superseded hashes of known sources."""
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_build
    from cs230_distributed_machine_learning_tpu_torch.utils import aot_cache

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(aot_cache, "enabled", lambda: True)
    current = cuda_build.library_path("logreg")
    (tmp_path / current.name).write_bytes(b"x" * 10)
    stale = tmp_path / "liblogreg-000000000000.so"
    stale.write_bytes(b"y")
    (tmp_path / "liblogreg-000000000000.log").write_text("log")
    other = tmp_path / "libunrelated-000000000000.so"
    other.write_bytes(b"z")
    inv = aot_cache.generation_inventory()
    assert inv["n_blobs"] == 1 and inv["bytes"] == 10 and inv["generation"]
    assert aot_cache._prune_stale_generations(max_age_s=1e9) == 0  # too recent
    assert aot_cache._prune_stale_generations(max_age_s=0.0) == 2
    assert not stale.exists() and other.exists() and (tmp_path / current.name).exists()
    monkeypatch.setenv("CS230_AOT_CACHE", "0")
    monkeypatch.undo()
    assert aot_cache.cache_dir() == str(cuda_build.BUILD_DIR)
