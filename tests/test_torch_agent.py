"""The port's worker agents over real sockets, on the CPU.

- A ``WorkerAgent`` with a storage root of its own, on the port's server
  (port 0), fetches iris and a dataset the coordinator staged with
  ``stage_arrays`` through ``GET /dataset/<id>`` (``FetchingDatasetCache``)
  and runs the jobs ``MLTaskManager(url=...)`` submits (a blocking train, a
  streamed one, status, per-trial metrics, curves, the winner's artifact
  over HTTP); the scores match the JAX package's local run of the same
  search.
- A fatal CUDA error in an agent's batch ends its process with exit code
  13 (``DEVICE_LOST_EXIT_CODE``) and posts no result.
- An ``AgentSupervisor`` child agent on ``--device cpu`` is SIGKILLed
  after its first result: the dead-worker sweep requeues its tasks, the
  supervisor respawns the child, and the job completes with the scores of
  the same job run in process.

Every agent is stopped and its threads joined before its server shuts
down, and every server binds port 0.
"""

import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.runtime import agent as tagent
from cs230_distributed_machine_learning_tpu_torch.runtime import executor as texec
from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
from cs230_distributed_machine_learning_tpu_torch.runtime.server import start_server
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

SEARCH = GridSearchCV(LogisticRegression(max_iter=100), {"C": [0.01, 0.1, 1.0, 10.0]}, cv=3)


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    cfg.service.sse_tick_s = 0.05
    cfg.service.client_poll_s = 0.05
    cfg.scheduler.heartbeat_interval_s = 0.1
    cfg.scheduler.dead_after_s = 1.5
    cfg.scheduler.sweep_interval_s = 0.1
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


@pytest.fixture()
def served():
    """A coordinator with a cluster and no executor, served on port 0."""
    cluster = ClusterRuntime()
    coord = Coordinator(device="cpu", cluster=cluster)
    server, thread = start_server(coord)
    yield coord, server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)
    cluster.shutdown()


def _scores(status):
    return {json.dumps(r["search_params"], sort_keys=True): r["mean_cv_score"]
            for r in status["job_result"]["results"]}


def test_agent_over_a_socket_runs_rest_jobs(served, tmp_path):
    from cs230_distributed_machine_learning_tpu_torch.data.datasets import stage_arrays

    coord, server = served
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    stage_arrays("staged_blobs", X, y, root=coord.config.storage.datasets_dir)
    agent = tagent.WorkerAgent(server.url, device="cpu", poll_timeout_s=0.3,
                               datasets_root=str(tmp_path / "agent_datasets"))
    agent.start()
    try:
        manager = TorchManager(url=server.url)
        assert manager.check_data("iris") == {"exists": False, "path": None}
        status = manager.train(SEARCH, "iris", show_progress=False, timeout=120)
        assert status["job_status"] == "completed"
        assert {r["worker_id"] for r in status["job_result"]["results"]} == {agent.worker_id}
        streamed = manager.train(SEARCH, "iris", show_progress=False, timeout=120, stream=True)
        assert streamed["job_status"] == "completed" and _scores(streamed) == _scores(status)
        assert len(manager.check_job_status()) == 4
        assert manager.curves()["n_curves"] == 4
        with pytest.raises(KeyError):
            manager.curves("no-such-job")
        path = manager.download_best_model(output_path=str(tmp_path / "best.pkl"))
        artifact = manager.load_best_model(as_sklearn=False)
        assert os.path.getsize(path) > 0 and artifact["model_type"] == "LogisticRegression"
        blobs = manager.train(GridSearchCV(LogisticRegression(max_iter=50), {"C": [1.0]}, cv=3),
                              "staged_blobs", show_progress=False, timeout=120)
        assert blobs["job_status"] == "completed"
        assert blobs["job_result"]["best_result"]["mean_cv_score"] > 0.9
        fetched = {f["dataset_id"]: f for f in agent.executor.cache.fetches}
        assert fetched["staged_blobs"]["kind"] == "preprocessed"
        assert fetched["iris"]["bytes"] > 0
    finally:
        agent.stop()
    assert not agent.alive()
    reference = JaxManager().train(SEARCH, "iris", show_progress=False)
    ref, got = _scores(reference), _scores(status)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=2e-3), k
    assert (status["job_result"]["best_result"]["search_params"]
            == reference["job_result"]["best_result"]["search_params"])


def test_fatal_cuda_error_ends_the_agent_with_exit_code_13(served, monkeypatch, tmp_path):
    coord, server = served
    exits = []

    def poisoned(*a, **k):
        raise RuntimeError("packed_nesterov_step failed: CUDA error 700")

    monkeypatch.setattr(texec, "run_trials", poisoned)
    agent = tagent.WorkerAgent(server.url, device="cpu", poll_timeout_s=0.3,
                               datasets_root=str(tmp_path / "agent_datasets"))

    def fake_exit(code):
        exits.append(code)
        agent._stop.set()  # the poll loop ends, as the process would

    monkeypatch.setattr(tagent.os, "_exit", fake_exit)
    posted = []
    agent._post_result = lambda *a: posted.append(a)
    agent.start()
    try:
        manager = TorchManager(url=server.url)
        manager.train(SEARCH, "iris", wait_for_completion=False)
        deadline = time.time() + 60
        while not exits and time.time() < deadline:
            time.sleep(0.05)
    finally:
        agent.stop()
    assert exits == [tagent.DEVICE_LOST_EXIT_CODE] == [13]
    assert posted == []  # the tasks stay queued for the dead-worker requeue


def test_supervised_child_agent_is_killed_and_respawned(served, tmp_path):
    from cs230_distributed_machine_learning_tpu_torch.runtime.supervisor import (
        AgentSupervisor,
        agent_command,
    )

    coord, server = served
    child_env = {"CUDA_VISIBLE_DEVICES": "",
                 "TPUML_STORAGE__ROOT": str(tmp_path / "child_root"),
                 "TPUML_SCHEDULER__HEARTBEAT_INTERVAL_S": "0.1",
                 "OMP_NUM_THREADS": "1"}
    # one trial a pull, sixteen trials: the child is still busy when it dies
    search = GridSearchCV(LogisticRegression(max_iter=100),
                          {"C": np.logspace(-3, 2, 16).tolist()}, cv=3)
    cmd = agent_command(server.url, max_batch=1)
    assert cmd[:3] == [sys.executable, "-m",
                       "cs230_distributed_machine_learning_tpu_torch.runtime.agent"]
    # the server's way to put a slot on the CPU: --device cpu, no card visible
    sup = AgentSupervisor(cmd, n=1, slot_envs=[child_env], slot_args=[["--device", "cpu"]],
                          backoff_s=0.2, poll_interval_s=0.1)
    sup.start()
    try:
        manager = TorchManager(url=server.url)
        submit = manager.train(search, "iris", wait_for_completion=False)
        sid, jid = manager.session_id, submit["job_id"]
        deadline = time.time() + 120
        while coord.store.job_progress(sid, jid)["tasks_completed"] < 1:
            assert time.time() < deadline, "no result from the child agent"
            time.sleep(0.01)
        victim = sup.status()[0]["pid"]
        os.kill(victim, signal.SIGKILL)
        status = manager._wait_remote(timeout=120, show_progress=False)
        slot = sup.status()[0]
    finally:
        sup.stop()
    assert status["job_status"] == "completed"
    results = status["job_result"]["results"]
    assert len({r["subtask_id"] for r in results}) == 16 and not status["job_result"]["failed"]
    assert slot["restarts_total"] >= 1 and slot["pid"] != victim
    assert len({r["worker_id"] for r in results}) >= 2  # the respawned child finished it
    local = TorchManager(device="cpu").train(search, "iris", show_progress=False)
    ref, got = _scores(local), _scores(status)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=2e-3), k
