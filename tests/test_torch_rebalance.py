"""The port's cross-shard rebalancing against the JAX package, on the CPU.

The journal ops of migration and stealing (``mesh_gen``, ``migrate_out``,
``migrate_in``, ``steal``; runtime/store.py) run as the same op sequence
through both packages' ``JobStore`` and are replayed across a restart:
the replayed records, stamps and tombstones must be the same, each
package must read the other's journal, and every truncation point must
replay without raising (tests/test_rebalance.py's cases). Then the live
paths in process: the donor's 409 forwarding stamp, the front end's
cached redirect, a quiesce -> fence -> export -> adopt migration between
two port coordinators over HTTP, and a steal grant settled by relayed
results.
"""

import json
import os
import shutil
import time
import uuid

import pytest
import torch

from cs230_distributed_machine_learning_tpu.runtime.store import JobStore as JaxStore
from cs230_distributed_machine_learning_tpu_torch.runtime.store import JobStore as TorchStore
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


SID = "7f3c2b1a-0000-4000-8000-000000000015"


def _migrate_out(store):
    store.create_session(SID)
    store.create_job(SID, "m", {"dataset_id": "iris"},
                     [{"subtask_id": f"m-s{i}"} for i in range(2)])
    store.update_subtask(SID, "m", "m-s0", "completed", {"mean_cv_score": 0.9})
    store.record_migrate_out(SID, "m", 1)


def _migrate_in(store):
    store.create_session(SID, priority=3)
    record = {"job_id": "m", "payload": {"dataset_id": "iris"}, "created_at": 1.0,
              "total_subtasks": 3, "completed_subtasks": 1, "failed_subtasks": 0,
              "pruned_subtasks": 0, "diverged_subtasks": 0, "status": "33.3%",
              "subtasks": {f"m-s{i}": {"spec": {"subtask_id": f"m-s{i}", "attempt": 1},
                                       "status": "completed" if i == 0 else "pending",
                                       "result": {"mean_cv_score": 0.9} if i == 0 else None}
                           for i in range(3)},
              "metadata": {}, "result": None, "migrated_to": 2}
    store.import_job(SID, record, source_shard=0)


def _steal(store):
    store.create_session(SID)
    store.create_job(SID, "t", {}, [{"subtask_id": f"t-s{i}"} for i in range(3)])
    store.record_steal(SID, "t", "t-s0", thief_shard=1, attempt=2)
    store.record_steal(SID, "t", "t-s1", thief_shard=1, attempt=1)
    store.update_subtask(SID, "t", "t-s0", "completed", {"mean_cv_score": 0.8, "attempt": 2})


def _mixed(store):
    """Every rebalance op interleaved with job traffic (the crash-point
    fuzz journal of tests/test_rebalance.py), plus a mesh generation."""
    store.create_session(SID)
    store.create_job(SID, "rb", {"dataset_id": "iris"},
                     [{"subtask_id": f"rb-s{i}"} for i in range(3)])
    store.record_mesh_generation(3, "join")
    store.record_steal(SID, "rb", "rb-s0", thief_shard=1, attempt=1)
    store.update_subtask(SID, "rb", "rb-s0", "completed", {"mean_cv_score": 0.9, "attempt": 1})
    store.record_steal(SID, "rb", "rb-s1", thief_shard=1, attempt=2)
    store.record_mesh_generation(4, "death")
    store.record_migrate_out(SID, "rb", 1)


SEQUENCES = {"migrate_out": _migrate_out, "migrate_in": _migrate_in, "steal": _steal,
             "mixed": _mixed}


def _state(store) -> dict:
    """What a replay restores, without wall-clock fields."""
    jobs = {}
    for sid, jid in [(s, j["job_id"]) for j in store.jobs_overview()
                     for s in [j["session_id"]]]:
        rec = store.get_job(sid, jid)
        rec.pop("created_at", None)
        jobs[jid] = {"record": rec, "progress": store.job_progress(sid, jid),
                     "migrated_to": store.migrated_to(jid),
                     "adopted": store.is_adopted_job(jid)}
    return {
        "jobs": jobs,
        "tombstones": {k: {f: v[f] for f in ("sid", "jid", "thief", "attempt")}
                       for k, v in store.steal_tombstones.items()},
        "unfinished": sorted(store.unfinished_jobs()),
        "counts": store.unfinished_counts(),
        "mesh_generation": store.mesh_generation,
        "priority": store.session_priority(SID),
        "replay_ops": dict(store.replay_ops),
        "replay_skipped": store.replay_skipped,
    }


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_journal_ops_replay_like_jax(tmp_path, name):
    """The same op sequence through both stores: the same live state, the
    same state after a restart, and each package reads the other's
    journal into that state."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    j, t = JaxStore(journal_dir=jd), TorchStore(journal_dir=td)
    SEQUENCES[name](j)
    SEQUENCES[name](t)
    assert _state(t) == _state(j)
    jr, tr = JaxStore(journal_dir=jd), TorchStore(journal_dir=td)
    assert tr.replay_skipped == 0
    assert _state(tr) == _state(jr)
    # either package replays the other's journal
    cross = str(tmp_path / "cross")
    shutil.copytree(jd, cross)
    assert _state(TorchStore(journal_dir=cross)) == _state(jr)
    cross2 = str(tmp_path / "cross2")
    shutil.copytree(td, cross2)
    assert _state(JaxStore(journal_dir=cross2)) == _state(tr)


def test_journal_lines_match_jax(tmp_path):
    """The journal entries themselves, op for op (wall-clock fields
    dropped): either package's journal is the other's format."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    _mixed(JaxStore(journal_dir=jd))
    _mixed(TorchStore(journal_dir=td))

    def lines(d):
        out = []
        with open(os.path.join(d, "jobs.jsonl")) as f:
            for ln in f:
                e = json.loads(ln)
                if e.get("op") == "create_job":
                    e["record"].pop("created_at", None)
                out.append(e)
        return out

    assert lines(td) == lines(jd)


def test_crash_point_fuzz_matches_jax(tmp_path):
    """Every truncation of the mixed journal replays without raising, and
    re-appending the suffix restores the whole state, in both packages
    alike."""
    full = str(tmp_path / "full")
    _mixed(TorchStore(journal_dir=full))
    lines = open(os.path.join(full, "jobs.jsonl"), "rb").read().splitlines(keepends=True)
    want = _state(TorchStore(journal_dir=full))
    assert want["jobs"]["rb"]["migrated_to"] == 1 and list(want["tombstones"]) == ["rb-s1"]
    for i in range(len(lines) + 1):
        for pkg, Store in (("torch", TorchStore), ("jax", JaxStore)):
            d = str(tmp_path / f"{pkg}{i}")
            os.makedirs(d)
            path = os.path.join(d, "jobs.jsonl")
            with open(path, "wb") as f:
                f.writelines(lines[:i])
            cut = Store(journal_dir=d)
            assert cut.replay_skipped == 0
            if pkg == "torch":
                ref_cut = _state(cut)
            else:
                assert _state(cut) == ref_cut
            with open(path, "ab") as f:
                f.writelines(lines[i:])
            resumed = Store(journal_dir=d)
            got = _state(resumed)
            assert {k: got[k] for k in ("jobs", "tombstones", "mesh_generation")} == {
                k: want[k] for k in ("jobs", "tombstones", "mesh_generation")}


# ---------------- the live paths ----------------


def _grid_payload(n):
    return {"dataset_id": "iris",
            "model_details": {"model_type": "LogisticRegression", "search_type": "GridSearchCV",
                              "base_estimator_params": {"max_iter": 50},
                              "param_grid": {"C": [0.1, 1.0, 10.0, 100.0][:n]},
                              "cv_params": {"cv": 3}},
            "train_params": {"random_state": 42}}


def _wait_queued(cluster, n, timeout_s=30):
    deadline = time.time() + timeout_s
    while sum(len(q) for q in cluster.engine.queue_snapshot().values()) < n:
        assert time.time() < deadline, f"never saw {n} queued subtasks"
        time.sleep(0.05)


@pytest.fixture
def two_shards():
    """Two port shard coordinators over HTTP: the donor's only worker is a
    registered remote that never polls (its queue parks), the recipient
    has a CPU executor."""
    from cs230_distributed_machine_learning_tpu_torch.data.datasets import materialize_builtin
    from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
    from cs230_distributed_machine_learning_tpu_torch.runtime.server import start_server

    materialize_builtin("iris")
    cluster_a = ClusterRuntime(shard_id=0)
    cluster_a.register_remote(None)
    donor = Coordinator(cluster=cluster_a, shard_id=0, n_shards=2, device="cpu")
    cluster_b = ClusterRuntime(shard_id=1)
    cluster_b.add_executor(device="cpu")
    recipient = Coordinator(cluster=cluster_b, shard_id=1, n_shards=2, device="cpu")
    (srv_a, _), (srv_b, _) = start_server(donor), start_server(recipient)
    donor.peer_urls = recipient.peer_urls = [srv_a.url, srv_b.url]
    yield donor, recipient, srv_a.url, srv_b.url
    for srv in (srv_a, srv_b):
        srv.shutdown()
        srv.server_close()
    cluster_a.shutdown()
    cluster_b.shutdown()


def test_migrate_job_between_live_coordinators(two_shards):
    """The donor's queued job moves to the recipient, which finishes it
    under fenced attempts and the donor's stamp; the donor answers 409
    moved, and a front end over both follows the stamp once and then its
    cache."""
    from cs230_distributed_machine_learning_tpu_torch.obs import REGISTRY
    from cs230_distributed_machine_learning_tpu_torch.runtime.frontend import FrontendApp
    from cs230_distributed_machine_learning_tpu_torch.runtime.sharding import id_shard, shard_of
    from cs230_distributed_machine_learning_tpu_torch.utils import http

    donor, recipient, url_a, url_b = two_shards
    sid = donor.create_session()
    assert shard_of(sid, 2) == 0  # a shard mints ids that hash home
    jid = donor.submit_train(sid, _grid_payload(2))["job_id"]
    assert id_shard(jid) == 0
    _wait_queued(donor.cluster, 2)
    assert donor.migrate_job(sid, jid, 1) is True
    assert donor.store.migrated_to(jid) == 1
    assert sum(len(q) for q in donor.cluster.engine.queue_snapshot().values()) == 0
    r = http.request("GET", f"{url_a}/check_status/{sid}/{jid}", timeout=10)
    assert r.status == 409 and r.json() == {"status": "moved", "migrated_to": 1, "job_id": jid}
    assert recipient.store.wait_job(sid, jid, timeout=60)
    assert recipient.canonical_job_id(jid) == jid  # adopted: the donor's stamp
    status = recipient.check_status(sid, jid)
    assert status["job_status"] == "completed"
    assert len({x["subtask_id"] for x in status["job_result"]["results"]}) == 2
    job = recipient.store.get_job(sid, jid)
    assert all(int(s["spec"].get("attempt") or 0) >= 1 for s in job["subtasks"].values())
    jobs = {u: [j for j in http.request("GET", f"{u}/jobs", timeout=10).json()
                if j["job_id"] == jid] for u in (url_a, url_b)}
    assert jobs[url_a][0]["migrated_to"] == 1 and jobs[url_b][0]["migrated_from"] == 0
    fe = FrontendApp([url_a, url_b])
    fwd = REGISTRY.counter("tpuml_frontend_forwarded_total")
    before = fwd.value()
    for _ in range(2):
        code, _, chunks = fe.handle("GET", f"/check_status/{sid}/{jid}", "", {}, b"")
        assert code == 200 and json.loads(b"".join(chunks))["job_status"] == "completed"
    assert fwd.value() == before + 1  # the second request rode the cache


def test_migrate_refused_without_peer_and_route(two_shards):
    from cs230_distributed_machine_learning_tpu_torch.utils import http

    donor, _, url_a, _ = two_shards
    sid = donor.create_session()
    jid = donor.submit_train(sid, _grid_payload(1))["job_id"]
    _wait_queued(donor.cluster, 1)
    assert donor.migrate_job(sid, jid, 7) is False  # no such peer
    bad = http.request("POST", f"{url_a}/migrate_job",
                       json={"session_id": sid, "job_id": jid, "dest_shard": 0}, timeout=10)
    assert bad.status == 400
    ok = http.request("POST", f"{url_a}/migrate_job",
                      json={"session_id": sid, "job_id": jid, "dest_shard": 1},
                      timeout=60).json()
    assert ok == {"migrated": True, "job_id": jid, "dest_shard": 1}


def test_steal_grant_fences_tombstones_and_results_settle():
    """Only non-head queued subtasks are offered; a grant bumps attempts,
    journals tombstones and releases queue entries; relayed results settle
    the job; the disabled valve offers nothing."""
    from cs230_distributed_machine_learning_tpu_torch.data.datasets import materialize_builtin
    from cs230_distributed_machine_learning_tpu_torch.runtime.cluster import ClusterRuntime
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    materialize_builtin("iris")
    svc = tcfg.get_config().service
    cluster = ClusterRuntime(shard_id=0)
    cluster.register_remote(None)
    coord = Coordinator(cluster=cluster, shard_id=0, n_shards=2, device="cpu")
    try:
        sid = coord.create_session()
        jid = coord.submit_train(sid, _grid_payload(4))["job_id"]
        _wait_queued(cluster, 4)
        assert coord.steal_candidates()["candidates"] == []
        assert coord.release_for_steal(1, 8) == []
        svc.rebalance_enabled = True
        svc.rebalance_hot_pressure = 0.0
        coord.signals.evaluate(force=True)
        offered = {c["subtask_id"] for c in coord.steal_candidates()["candidates"]}
        assert len(offered) == 3  # the queue head is withheld
        granted = coord.release_for_steal(1, max_n=8)
        assert {t["subtask_id"] for t in granted} == offered
        assert all(int(t.get("attempt") or 0) >= 1 and t["stolen_from"] == 0 for t in granted)
        assert set(coord.store.steal_tombstones) == offered
        assert sum(len(q) for q in cluster.engine.queue_snapshot().values()) == 1
        job = coord.store.get_job(sid, jid)
        for stid, sub in job["subtasks"].items():
            coord.ingest_peer_result({"subtask_id": stid, "job_id": jid, "status": "completed",
                                      "mean_cv_score": 0.9, "accuracy": 0.9,
                                      "attempt": int(sub["spec"].get("attempt") or 0)})
        assert coord.store.wait_job(sid, jid, timeout=60)
        assert coord.store.steal_tombstones == {}
        assert len(coord.check_status(sid, jid)["job_result"]["results"]) == 4
    finally:
        cluster.shutdown()


def test_canonical_ids_and_shard_minted_sessions():
    """A shard stamps client-minted ids deterministically; an unsharded
    coordinator leaves them; a front-end-minted session id hashing
    elsewhere is refused over REST."""
    from cs230_distributed_machine_learning_tpu.runtime.sharding import stamp_job_id
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
    from cs230_distributed_machine_learning_tpu_torch.runtime.server import create_app
    from cs230_distributed_machine_learning_tpu_torch.runtime.sharding import shard_of

    shard = Coordinator(shard_id=1, n_shards=3, device="cpu")
    plain = Coordinator(device="cpu")
    for jid in ("retry-1", str(uuid.UUID(int=3)), "s01-x"):
        assert shard.canonical_job_id(jid) == stamp_job_id(1, jid)
        assert plain.canonical_job_id(jid) == jid
    app = create_app(shard)
    away = next(s for s in (str(uuid.UUID(int=i)) for i in range(50)) if shard_of(s, 3) != 1)
    code, _, body = app.handle("POST", "/create_session", "", {},
                               json.dumps({"session_id": away}).encode())
    assert code == 400
    home = next(s for s in (str(uuid.UUID(int=i)) for i in range(50)) if shard_of(s, 3) == 1)
    code, _, body = app.handle("POST", "/create_session", "", {},
                               json.dumps({"session_id": home}).encode())
    assert code == 201 and json.loads(b"".join(body)) == {"session_id": home, "shard": 1}
