"""A rank of the port's SPMD worker lost mid-job, on the CPU (the port's
counterpart of the JAX package's ``tests/test_chaos_spmd.py:79``
``test_spmd_host_loss_requeues_onto_survivor``).

A port server (a CPU coordinator with no executor of its own) and a
2-rank gloo slice, each rank a ``python -m
cs230_distributed_machine_learning_tpu_torch.runtime.agent --distributed
... --device cpu`` process with small batches; heartbeats every 1 s, a
worker dead after 3 s, sweeps every 1 s. The chain under test:

1. rank 1 is SIGKILLed once the job has posted some results;
2. rank 0's slice watchdog (``runtime/agent.py::_slice_watchdog``) sees
   its sibling's heartbeat go stale and exits with
   ``DEVICE_LOST_EXIT_CODE`` (13), which stops the slice's worker
   heartbeats;
3. the coordinator's dead-worker sweep requeues the slice's pulled tasks;
4. a single-process agent finishes the job: every trial completes once,
   and ``best_params_`` equals a clean run's of the same search on that
   agent.

Every wait has a deadline and every process is killed in ``finally``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import torch
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import GridSearchCV

from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.runtime.agent import DEVICE_LOST_EXIT_CODE
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT = "cs230_distributed_machine_learning_tpu_torch.runtime.agent"
#: 16 trials over at least 8 pulls of 2: the kill lands with work queued
GRID = {"C": [0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0], "tol": [1e-4, 1e-3]}
#: fast failure detection, the JAX drill's settings
SCHEDULER = {"heartbeat_interval_s": 1.0, "dead_after_s": 3.0, "sweep_interval_s": 1.0}


def _search():
    return GridSearchCV(LogisticRegression(max_iter=300), GRID, cv=3)


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=5) as r:
        return json.load(r)


def _wait(cond, timeout, what, procs=()):
    deadline = time.time() + timeout
    while time.time() < deadline:
        for name, p in procs:
            assert p.poll() is None, f"{name} exited early with {p.returncode}"
        try:
            if cond():
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def test_rank_lost_mid_job_requeues_onto_a_survivor(tmp_path):
    from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
    from cs230_distributed_machine_learning_tpu_torch.runtime.fleet import free_port
    from cs230_distributed_machine_learning_tpu_torch.runtime.server import start_server

    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "server")
    for k, v in SCHEDULER.items():
        setattr(cfg.scheduler, k, v)
    tcfg.set_config(cfg)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PYTHONUNBUFFERED": "1", "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
           **{f"TPUML_SCHEDULER__{k.upper()}": str(v) for k, v in SCHEDULER.items()}}
    logs, procs = {}, {}

    def spawn(name, *args):
        logs[name] = open(tmp_path / f"{name}.log", "w+")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", AGENT, *args],
            env={**env, "TPUML_STORAGE__ROOT": str(tmp_path / name)}, cwd=REPO,
            stdout=logs[name], stderr=subprocess.STDOUT)
        return procs[name]

    def tail(name):
        logs[name].flush()
        logs[name].seek(0)
        return f"--- {name}:\n" + logs[name].read()[-3000:]

    cluster = ClusterRuntime()
    coord = Coordinator(cluster=cluster, device="cpu")
    srv, _ = start_server(coord)
    url = srv.url
    job = threading.Thread()
    try:
        address = f"127.0.0.1:{free_port()}"
        for rank in (0, 1):
            spawn(f"rank{rank}", "--url", url, "--device", "cpu", "--distributed",
                  "--coordinator-address", address, "--num-processes", "2",
                  "--process-id", str(rank), "--max-batch", "2")
        ranks = [(n, procs[n]) for n in ("rank0", "rank1")]
        _wait(lambda: _get(url, "/workers"), 60, "the slice to register", ranks)

        box = {}

        def run_job():
            box["status"] = TorchManager(url=url).train(_search(), "iris", timeout=60,
                                                        show_progress=False)

        job = threading.Thread(target=run_job, daemon=True)
        job.start()

        def mid_job():
            return any(0 < (j.get("completed_subtasks") or 0) < (j.get("total_subtasks") or 99)
                       for j in _get(url, "/jobs"))

        _wait(mid_job, 60, "the job to post some results", ranks)
        procs["rank1"].send_signal(signal.SIGKILL)
        t_kill = time.time()

        # the watchdog takes rank 0 down too: without it the dead slice
        # would heartbeat forever and the job would hang
        _wait(lambda: procs["rank0"].poll() is not None, 30, "rank 0's watchdog")
        assert procs["rank0"].returncode == DEVICE_LOST_EXIT_CODE, tail("rank0")
        watchdog_s = time.time() - t_kill

        spawn("fallback", "--url", url, "--device", "cpu")
        job.join(timeout=60)
        assert not job.is_alive(), "the job did not finish after the failover\n" + tail("fallback")
        status = box["status"]
        assert status["job_status"] == "completed", status
        result = status["job_result"]
        assert len(result["results"]) == 16 and not result.get("failed"), result
        assert len({r["subtask_id"] for r in result["results"]}) == 16

        clean = TorchManager(url=url).train(_search(), "iris", timeout=60, show_progress=False)
        assert clean["job_status"] == "completed"
        assert (result["best_result"]["search_params"]
                == clean["job_result"]["best_result"]["search_params"]), (
            result["best_result"], clean["job_result"]["best_result"])
        assert watchdog_s < 3.0 + 2 * SCHEDULER["heartbeat_interval_s"] + 5.0, watchdog_s
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            p.wait(timeout=30)
        for f in logs.values():
            f.close()
        srv.shutdown()
        srv.server_close()
        cluster.shutdown()
        tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def test_agree_reads_only_a_collective_failure_as_a_lost_rank(monkeypatch):
    """``agree`` turns what gloo raises for a dead peer (a bare
    RuntimeError) into ``LockstepLostError``, which ends the rank for a
    slice relaunch; any other error of its all-gather (an argument or
    payload fault) goes up unchanged, so a bug never reads as a lost rank."""
    import pytest

    from cs230_distributed_machine_learning_tpu_torch.parallel import distributed as td

    def gather(err):
        def fn(values, mesh=None):
            raise err
        return fn

    monkeypatch.setattr(td, "all_gather_ints", gather(RuntimeError("Connection closed by peer")))
    with pytest.raises(td.LockstepLostError):
        td.agree(True)
    for err in (TypeError("bad payload"), ValueError("bad shape")):
        monkeypatch.setattr(td, "all_gather_ints", gather(err))
        with pytest.raises(type(err)) as info:
            td.agree(True)
        assert not isinstance(info.value, td.LockstepLostError)
