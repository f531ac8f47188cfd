"""The port's SPMD worker over two gloo ranks against the JAX package, on
the CPU: ``parallel/distributed.py``, the trial engine's sharding
(parallel/trial_map.py) and the agent's ``run_distributed``
(runtime/agent.py) behind a port server.

Two ranks are spawned with ``torch.multiprocessing`` (rank 0 talks REST,
both run every batch in lockstep, each with a fresh storage root, so the
datasets reach them through ``GET /dataset``); the JAX reference runs on
one device in process. A LogReg search: ``best_params_`` equal to the JAX
package's, every ``mean_cv_score`` within 2e-3 of JAX (PERF.md §2) and
within 1e-6 of the port's one-rank run (a CPU matmul over fewer lanes may
round differently; bit equality is held on the card), the winner marked
by the mesh collective. A forest over the chunked protocol: within 1e-6 of
JAX. A batch that fails on rank 1 alone, before the engine runs or inside
it, fails on both ranks, and the slice stays in step for the next job.
Every process, join and HTTP wait has a timeout.
"""

import json

import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import GridSearchCV
from sklearn.naive_bayes import GaussianNB
from sklearn.tree import DecisionTreeClassifier

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models import trees as jmt
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

TIMEOUT_S = 120
DATASET = "synthetic_600x8x3"
#: the forest's route: the deep arena cut to 6 levels, in chunks of trees
FOREST_ENV = {"CS230_TREE_DEEP_N": "256", "CS230_TREE_CHUNK_MACS": "1e8"}


#: model types whose batches fail on rank 1 alone: before the engine runs
#: (the executor's fault injector), and inside it (out of memory staging)
FAULT_BEFORE, FAULT_IN = "GaussianNB", "DecisionTreeClassifier"


def _inject_rank1_faults():
    from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map
    from cs230_distributed_machine_learning_tpu_torch.runtime import executor

    class OneModelFault(executor.FaultInjector):
        def before_batch(self, executor_id, model_type):
            if model_type == FAULT_BEFORE:
                raise RuntimeError(f"fault injection: {model_type} batch failure on rank 1")

    init, stage_x = executor.LocalExecutor.__init__, trial_map._Staging.X

    def patched_init(self, *a, **k):
        init(self, *a, **k)
        self.fault_injector = OneModelFault()

    def patched_x(self, kernel, static, prepared):
        if kernel.name == FAULT_IN:
            raise torch.OutOfMemoryError("fault injection: out of memory staging on rank 1")
        return stage_x(self, kernel, static, prepared)

    executor.LocalExecutor.__init__ = patched_init
    trial_map._Staging.X = patched_x


def _rank(rank, address, url, root, q):
    """One rank: join the gloo group, serve batches until rank 0 is
    stopped (SIGTERM). Rank 1 fails the batches of ``FAULT_BEFORE`` and
    ``FAULT_IN``."""
    torch.set_num_threads(1)
    if rank == 1:
        _inject_rank1_faults()
    from cs230_distributed_machine_learning_tpu_torch.models import trees
    from cs230_distributed_machine_learning_tpu_torch.parallel.distributed import (
        init_distributed, shutdown)
    from cs230_distributed_machine_learning_tpu_torch.runtime.agent import run_distributed
    from cs230_distributed_machine_learning_tpu_torch.utils import config

    trees._DEEP_LEVELS = 6
    cfg = config.FrameworkConfig.load(env={})
    cfg.storage.root = root
    config.set_config(cfg)
    try:
        backend = init_distributed(address, 2, rank, device="cpu", timeout_s=TIMEOUT_S)
        q.put((rank, backend))
        run_distributed(url, device="cpu", poll_timeout_s=0.5)
        q.put((rank, "stopped"))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        q.put((rank, repr(e)))
    finally:
        shutdown()


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """A port server (CPU coordinator, no executor of its own) and an SPMD
    worker of two gloo ranks registered with it."""
    import os
    import time

    import torch.multiprocessing as mp

    from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
    from cs230_distributed_machine_learning_tpu_torch.runtime.fleet import free_port
    from cs230_distributed_machine_learning_tpu_torch.runtime.server import start_server

    base = tmp_path_factory.mktemp("spmd")
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(base / "server")
    # a failed batch fails its trials at once, and failures never evict the
    # one worker, so a job after the injected faults still has the slice
    cfg.scheduler.retry_max_attempts = 1
    cfg.scheduler.breaker_failure_ratio = 0.0
    tcfg.set_config(cfg)
    saved = {k: os.environ.get(k) for k in FOREST_ENV}
    os.environ.update(FOREST_ENV)  # the ranks inherit the forest's route
    cluster = ClusterRuntime()
    coord = Coordinator(cluster=cluster, device="cpu")
    srv, _ = start_server(coord)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, address, srv.url, str(base / f"rank{r}"), q),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        joined = dict(q.get(timeout=TIMEOUT_S) for _ in procs)
        assert joined == {0: "gloo", 1: "gloo"}, joined
        deadline = time.time() + TIMEOUT_S
        while not cluster.engine.workers:
            assert time.time() < deadline, "the SPMD worker never registered"
            time.sleep(0.05)
        yield {"url": srv.url, "cluster": cluster, "coord": coord}
        procs[0].terminate()  # SIGTERM: rank 0 broadcasts the stop
        stopped = dict(q.get(timeout=TIMEOUT_S) for _ in procs)
        assert stopped == {0: "stopped", 1: "stopped"}, stopped
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        srv.shutdown()
        srv.server_close()
        cluster.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


def _scores(status):
    return {json.dumps(r["search_params"], sort_keys=True): r for r in
            status["job_result"]["results"]}


def test_spmd_worker_reports_its_slice(spmd):
    (snap,) = spmd["cluster"].engine.worker_snapshot().values()
    assert snap["n_devices"] == 2 and snap["mesh_shape"] == {"trials": 2}


def test_logreg_search_on_two_ranks_matches_jax_and_one_rank(spmd):
    search = GridSearchCV(LogisticRegression(max_iter=80),
                          {"C": [0.01, 0.1, 1.0, 10.0, 100.0]}, cv=3)
    dist = TorchManager(url=spmd["url"]).train(search, DATASET, {"random_state": 42},
                                               timeout=TIMEOUT_S, show_progress=False)
    one = TorchManager(device="cpu").train(search, DATASET, {"random_state": 42},
                                           show_progress=False)
    ref = JaxManager().train(search, DATASET, {"random_state": 42}, show_progress=False)
    assert dist["job_status"] == one["job_status"] == ref["job_status"] == "completed"
    d, o, j = _scores(dist), _scores(one), _scores(ref)
    assert d.keys() == o.keys() == j.keys() and len(d) == 5
    for k in j:
        assert d[k]["mean_cv_score"] == pytest.approx(o[k]["mean_cv_score"], abs=1e-6), k
        assert d[k]["mean_cv_score"] == pytest.approx(j[k]["mean_cv_score"], abs=2e-3), k
    best = dist["job_result"]["best_result"]
    assert best["search_params"] == ref["job_result"]["best_result"]["search_params"]
    assert best["search_params"] == one["job_result"]["best_result"]["search_params"]
    assert best["winner_via"] == "ici_argmax"  # the JAX package's value
    # each pulled batch marks its own winner; the job's is among them
    marked = [r for r in dist["job_result"]["results"] if r.get("device_argmax")]
    assert marked and best["subtask_id"] in {r["subtask_id"] for r in marked}


def test_chunked_forest_on_two_ranks_matches_jax(spmd, monkeypatch):
    for k, v in FOREST_ENV.items():
        monkeypatch.setenv(k, v)
    for mod in (jmt, tmt):
        monkeypatch.setattr(mod, "_DEEP_LEVELS", 6)
    kernel = tmt.RandomForestClassifierKernel()
    static = kernel.resolve_static({"n_estimators": 4, "random_state": 42}, 600, 8, 3)
    static["_n_classes"] = 3
    assert kernel.chunked_plan(static, 600, 8, 3, 6)["n_chunks"] == 4
    est = RandomForestClassifier(n_estimators=4, random_state=42)
    dist = TorchManager(url=spmd["url"]).train(est, DATASET, {"random_state": 42},
                                               timeout=TIMEOUT_S, show_progress=False)
    ref = JaxManager().train(est, DATASET, {"random_state": 42}, show_progress=False)
    assert dist["job_status"] == ref["job_status"] == "completed"
    (d,), (j,) = dist["job_result"]["results"], ref["job_result"]["results"]
    assert d["mean_cv_score"] == pytest.approx(j["mean_cv_score"], abs=1e-6)
    assert d["accuracy"] == pytest.approx(j["accuracy"], abs=1e-6)
    assert d["cv_scores"] == pytest.approx(j["cv_scores"], abs=1e-6)
    assert dist["job_result"]["best_result"]["winner_via"] == "ici_argmax"


@pytest.mark.parametrize("estimator", [GaussianNB(), DecisionTreeClassifier(max_depth=3)],
                         ids=["before_the_engine", "in_the_engine"])
def test_a_batch_failing_on_one_rank_fails_on_every_rank(spmd, estimator):
    """Rank 1 fails its part of the batch alone; rank 0's part passed. The
    ranks agree on it before any result collective, so both fail the batch
    (rank 0 posts the failures, naming rank 1) and go back to the next
    broadcast in step: a LogReg job after it completes on both ranks."""
    grid = ({"var_smoothing": [1e-9, 1e-6]} if isinstance(estimator, GaussianNB)
            else {"min_samples_leaf": [1, 4]})
    failed = TorchManager(url=spmd["url"]).train(GridSearchCV(estimator, grid, cv=3), DATASET,
                                                 {"random_state": 42}, timeout=TIMEOUT_S,
                                                 show_progress=False)
    assert failed["job_status"] == "completed_with_failures", failed["job_status"]
    report = failed["job_result"]["failed_subtasks"]
    assert len(report) == 2 and not failed["job_result"]["results"]
    assert all("rank(s) [1] of the trial mesh failed" in r["error"] for r in report), report
    after = TorchManager(url=spmd["url"]).train(
        GridSearchCV(LogisticRegression(max_iter=40), {"C": [0.1, 1.0]}, cv=3), DATASET,
        {"random_state": 42}, timeout=TIMEOUT_S, show_progress=False)
    assert after["job_status"] == "completed"
    assert len(after["job_result"]["results"]) == 2


def test_backend_rule_and_broadcast_buckets():
    """The backend rule, and broadcast_json's bucket sizes (the JAX
    ``_MIN_BUCKET`` and power-of-two rule)."""
    from cs230_distributed_machine_learning_tpu.parallel import distributed as jd
    from cs230_distributed_machine_learning_tpu_torch.parallel import distributed as td

    assert td.choose_backend("cpu", 2, n_cards=8) == "gloo"
    assert td.choose_backend("cuda", 2, n_cards=1) == "gloo"  # ranks share a card
    assert td.choose_backend("cuda", 4, n_cards=4) == "nccl"
    assert td.choose_backend("cuda", 1, n_cards=1) == "nccl"
    assert td._MIN_BUCKET == jd._MIN_BUCKET == 4096
    # one process, no group: a local round trip
    assert td.broadcast_json({"a": [1, 2]}) == {"a": [1, 2]}
    assert td.process_index() == 0 and td.is_primary() and not td.is_multiprocess()
    out = td.fetch({"score": torch.ones(3, 2)})
    assert out["score"].shape == (3, 2)
