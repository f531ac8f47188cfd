"""The port's 2-D (trials, data) mesh over 4 gloo ranks against the JAX
package's ``trial_mesh(data_parallel=2)`` on the 8-device CPU mesh of the
conftest: ``parallel/mesh.py``, the row-sharded LogisticRegression of
``models/logistic.py`` on its three drivers, the row-sharded staging and
the scorers of ``models/base.py::score_lanes`` on a row shard.

One spawn of 4 CPU ranks builds a ``data_parallel=2`` mesh (2 trials x 2
data), a ``data_parallel=4`` mesh (1 x 4) and the 1-D mesh in one gloo
group, runs every case on them and sends the results back by a queue;
``data_parallel=3`` must raise on every rank. The JAX side gets the same
numpy inputs in this process.

- The packed route (``CS230_FORCE_PACKED=1``: B1's plain version, the
  gradient all-reduced between it and the update) and the B3 route
  (``CS230_MASKED_GRAD=pallas``: the generic nesterov driver with B3's
  plain version) on synthetic data drawn from a seed with wide class
  margins (no eval row on a decision edge; 5 % of the labels flipped
  deep inside another class): every ``mean_cv_score`` within 2e-3 of JAX
  2-D and of the port's own 1-D run.
- Newton on ``tests/test_2d_mesh.py``'s iris case: within one eval row
  (1/144 + 1e-6) of JAX 2-D, on both 2-D meshes. The reference's own 1-D
  and 2-D runs disagree by one row there, so ``best_params_`` are not
  held.
- A scored search with ``neg_log_loss`` (a reduced weighted sum), one
  with ``roc_auc`` (gathered margins) and one with ``roc_auc_ovr``
  (gathered probabilities), within 2e-3 of JAX 2-D.
- Data-group peers end with bit-identical weights (the packed path's last
  look-ahead weights, the generic driver's fitted W) and scores;
  ``row_range`` covers the rows once; ``mesh_info`` has JAX's form; a
  rank's staged X is its rows: its bytes are half the table's within a
  row.

Every spawn, join and wait has a timeout; the rendezvous port is free.
"""

import hashlib

import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris

from cs230_distributed_machine_learning_tpu.models.base import TrialData as JaxData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops.folds import build_split_plan as jax_plan
from cs230_distributed_machine_learning_tpu.parallel.mesh import mesh_info as jax_mesh_info
from cs230_distributed_machine_learning_tpu.parallel.mesh import trial_mesh as jax_mesh
from cs230_distributed_machine_learning_tpu.parallel.trial_map import run_trials as jax_run

torch.set_num_threads(1)

TIMEOUT_S = 240
RANKS = 4
TOL = 2e-3
#: one of the iris case's 144 eval rows, over its 3 folds' mean
IRIS_ROW = 1.0 / 144 + 1e-6
C_GRID = [0.01, 0.1, 1.0, 10.0, 100.0]


def _margin_data(n, d, c, seed):
    """Gaussian classes 8 apart with unit noise, 5 % of the labels flipped:
    a row is either deep in its class or deep in another."""
    rng = np.random.RandomState(seed)
    mu = rng.randn(c, d)
    mu = 8.0 * mu / np.linalg.norm(mu, axis=1, keepdims=True)
    y = rng.randint(0, c, n).astype(np.int32)
    X = (mu[y] + rng.randn(n, d)).astype(np.float32)
    flip = rng.rand(n) < 0.05
    y[flip] = (y[flip] + 1 + rng.randint(0, c - 1, int(flip.sum()))) % c
    return X, y, c


def _iris():
    X, y = load_iris(return_X_y=True)
    return X[:144].astype(np.float32), y[:144].astype(np.int32), 3


#: name -> (data, cv, params, scoring, port env, meshes). 63 features x 9
#: classes takes the nesterov solver; the packed route at 10 steps (its
#: plain version pads each rank's rows to 2,048 and costs ~0.5 s a step)
CASES = {
    "packed": (lambda: _margin_data(400, 63, 9, 0), 3,
               [{"C": c, "max_iter": 10} for c in C_GRID], None,
               {"CS230_FORCE_PACKED": "1"}, ("2d", "1d")),
    "b3": (lambda: _margin_data(400, 63, 9, 1), 3,
           [{"C": c, "max_iter": 40} for c in C_GRID], None,
           {"CS230_MASKED_GRAD": "pallas"}, ("2d", "1d")),
    "newton_iris": (_iris, 3, [{"C": c} for c in [0.1, 1.0, 10.0, 100.0]], None, {},
                    ("2d", "4d", "1d")),
    "neg_log_loss": (lambda: _margin_data(300, 63, 9, 2), 3,
                     [{"C": c, "max_iter": 40} for c in C_GRID], "neg_log_loss", {},
                     ("2d",)),
    "roc_auc": (lambda: _margin_data(300, 6, 2, 3), 3,
                [{"C": c} for c in C_GRID], "roc_auc", {}, ("2d",)),
    "roc_auc_ovr": (lambda: _margin_data(300, 6, 3, 4), 3,
                    [{"C": c} for c in C_GRID], "roc_auc_ovr", {}, ("2d",)),
}
#: rows of the row_range check: not a multiple of any data axis
RANGE_ROWS = 145
#: the manager job's builtin table (Newton at 8 features x 3 classes)
MANAGER_DATASET = "synthetic_600x8x3"


def _digest(t) -> str:
    raw = t.detach().cpu().contiguous().view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def _rank(rank, address, root, q):
    """One rank: join the group, build the meshes, run every case, put its
    results on ``q``."""
    import os

    torch.set_num_threads(1)
    from cs230_distributed_machine_learning_tpu_torch.utils import config

    cfg = config.FrameworkConfig.load(env={})
    cfg.storage.root = root
    config.set_config(cfg)
    from cs230_distributed_machine_learning_tpu_torch.data import stage_cache
    from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.parallel import distributed as D
    from cs230_distributed_machine_learning_tpu_torch.parallel.mesh import (
        mesh_info, trial_mesh)
    from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import run_trials

    cpu = torch.device("cpu")
    out = {}
    try:
        D.init_distributed(address, RANKS, rank, device="cpu", timeout_s=TIMEOUT_S)
        try:
            trial_mesh(device="cpu", data_parallel=3)
            out["dp3"] = "built"
        except ValueError as e:
            out["dp3"] = f"ValueError: {e}"
        meshes = {"2d": trial_mesh(device="cpu", data_parallel=2),
                  "4d": trial_mesh(device="cpu", data_parallel=4),
                  "1d": trial_mesh(device="cpu")}
        out["info"] = {k: mesh_info(m) for k, m in meshes.items()}
        out["coords"] = {k: (m.trial_rank, m.data_rank) for k, m in meshes.items()}
        out["row_range"] = {k: meshes[k].row_range(RANGE_ROWS) for k in ("2d", "4d")}
        # the packed path's look-ahead weights at each B1 call
        seen = []
        plain_grad = cuda_logreg.packed_softmax_grad

        def grad(Ab, W3, *a, **k):
            seen.append(W3)
            return plain_grad(Ab, W3, *a, **k)

        cuda_logreg.packed_softmax_grad = grad
        kernel = get_kernel("LogisticRegression")
        for name, (make, cv, params, scoring, env, on) in CASES.items():
            X, y, c = make()
            data = TrialData(X=X, y=y, n_classes=c)
            plan = build_split_plan(y, task="classification", n_folds=cv)
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                for tag in on:
                    stage_cache.STAGE_CACHE.clear()
                    seen.clear()
                    run = run_trials(kernel, data, plan, params, device=cpu, scoring=scoring,
                                     mesh=meshes[tag])
                    out[(name, tag)] = {
                        "scores": [m["mean_cv_score"] for m in run.trial_metrics],
                        "cv": [m.get("cv_scores") for m in run.trial_metrics],
                        "best": run.device_best,
                        "last_v": _digest(seen[-1]) if seen else None,
                        "b1_calls": len(seen),
                        "x_bytes": {repr(k[2:]): v for k, v in
                                    stage_cache.STAGE_CACHE.nbytes_by_key().items()
                                    if k[2] == "X"},
                    }
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        # the generic driver's fitted weights on a row shard, straight from fit
        X, y, c = CASES["b3"][0]()
        plan = build_split_plan(y, task="classification", n_folds=3)
        mesh = meshes["2d"]
        shard = mesh.row_shard(len(y))
        sl = slice(shard.lo, shard.hi)
        static = kernel.resolve_static(dict(kernel.static_defaults), len(y), X.shape[1], c)
        static = {**static, "_n_classes": c, "_iters": 40, "_row_shard": shard}
        hyper = {"C": torch.tensor([0.1, 1.0]), "max_iter": torch.tensor([40.0, 40.0]),
                 "tol": torch.tensor([1e-4, 1e-4])}
        W = kernel.fit(torch.as_tensor(X[sl]), torch.as_tensor(y[sl]),
                       torch.as_tensor(plan.train_w[:, sl]), hyper, static)
        out["fit_w"] = _digest(W)
        out["manager"] = _manager_job(meshes["2d"], rank)
        q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback

        q.put((rank, traceback.format_exc() + repr(e)))
    finally:
        D.shutdown()


def _manager_job(mesh, rank):
    """The entry a user calls: ``MLTaskManager(coordinator=Coordinator(
    mesh=mesh))`` on every rank, in direct mode, the same search on each;
    rank 0 also trains it without a mesh."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import GridSearchCV

    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator

    search = GridSearchCV(LogisticRegression(max_iter=50), {"C": C_GRID}, cv=3)
    coord = Coordinator(mesh=mesh)
    status = MLTaskManager(coordinator=coord).train(search, MANAGER_DATASET,
                                                    {"random_state": 42}, show_progress=False)
    out = {"executor_mesh": coord.executor.mesh is mesh, "device": str(coord.device),
           "status": status["job_status"], "scores": _by_params(status),
           "best": status["job_result"]["best_result"]["search_params"]}
    if rank == 0:
        solo = MLTaskManager(device="cpu").train(search, MANAGER_DATASET, {"random_state": 42},
                                                 show_progress=False)
        out["solo"] = _by_params(solo)
    return out


def _by_params(status):
    import json

    return {json.dumps(r["search_params"], sort_keys=True): r["mean_cv_score"]
            for r in status["job_result"]["results"]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    import torch.multiprocessing as mp

    from cs230_distributed_machine_learning_tpu_torch.runtime.fleet import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    base = tmp_path_factory.mktemp("mesh2d")
    procs = [ctx.Process(target=_rank, args=(r, address, str(base / f"rank{r}"), q),
                         daemon=True) for r in range(RANKS)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    bad = {r: v for r, v in got.items() if not isinstance(v, dict)}
    assert not bad, bad
    return [got[r] for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_2d():
    """The JAX package's scores of every case on its 2-D meshes (and the
    iris case's 1-D run, printed beside them)."""
    out = {}
    for name, (make, cv, params, scoring, _env, on) in CASES.items():
        X, y, c = make()
        data = JaxData(X=X, y=y, n_classes=c)
        plan = jax_plan(y, task="classification", n_folds=cv)
        kernel = jax_kernel("LogisticRegression")
        for tag in on:
            mesh = jax_mesh() if tag == "1d" else jax_mesh(data_parallel=2 if tag == "2d" else 4)
            run = jax_run(kernel, data, plan, params, mesh=mesh, scoring=scoring)
            out[(name, tag)] = [m["mean_cv_score"] for m in run.trial_metrics]
    return out


def test_mesh_shape_coordinates_and_rows(port):
    for r, got in enumerate(port):
        # data_parallel=3 on 4 ranks: test_2d_mesh_shape_validation's case
        assert got["dp3"].startswith("ValueError"), got["dp3"]
        assert got["info"]["2d"] == (4, {"trials": 2, "data": 2})
        assert got["info"]["4d"] == (4, {"trials": 1, "data": 4})
        assert got["info"]["1d"] == (4, {"trials": 4})
        assert got["coords"]["2d"] == (r // 2, r % 2)
        assert got["coords"]["4d"] == (0, r)
    # JAX's form at its own sizes: the axes, and the device count their product
    n, shape = jax_mesh_info(jax_mesh(data_parallel=2))
    assert (n, shape) == (8, {"trials": 4, "data": 2})
    for tag, k in (("2d", 2), ("4d", 4)):
        ranges = sorted({tuple(g["row_range"][tag]) for g in port})
        assert len(ranges) == k
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        assert np.array_equal(covered, np.arange(RANGE_ROWS))
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("name", ["packed", "b3", "neg_log_loss", "roc_auc", "roc_auc_ovr"])
def test_logreg_2d_matches_jax_2d_and_port_1d(port, jax_2d, name):
    got = port[0][(name, "2d")]["scores"]
    ref = jax_2d[(name, "2d")]
    print(name, "port 2-D", got, "JAX 2-D", ref)
    assert len(got) == len(ref) == len(CASES[name][2])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    if (name, "1d") in port[0]:
        np.testing.assert_allclose(got, port[0][(name, "1d")]["scores"], atol=TOL, rtol=0)
    if name == "packed":  # B1 once a step on every rank, 10 steps
        assert [g[(name, "2d")]["b1_calls"] for g in port] == [10] * RANKS


@pytest.mark.parametrize("tag", ["2d", "4d"])
def test_newton_iris_within_one_eval_row_of_jax_2d(port, jax_2d, tag):
    got = port[0][("newton_iris", tag)]["scores"]
    print(f"iris port {tag}", got, f"JAX {tag}", jax_2d[("newton_iris", tag)],
          "JAX 1-D", jax_2d[("newton_iris", "1d")], "port 1-D",
          port[0][("newton_iris", "1d")]["scores"])
    np.testing.assert_allclose(got, jax_2d[("newton_iris", tag)], atol=IRIS_ROW, rtol=0)


def test_data_group_peers_are_bit_identical(port):
    for name, (*_, on) in CASES.items():
        for tag in on:
            runs = [g[(name, tag)] for g in port]
            for r in range(1, RANKS):
                assert runs[r]["scores"] == runs[0]["scores"], (name, tag, r)
                assert runs[r]["cv"] == runs[0]["cv"], (name, tag, r)
                assert runs[r]["best"] == runs[0]["best"], (name, tag, r)
    # the packed path's look-ahead weights at its last step: equal within a
    # data group (ranks 2t and 2t+1), and the fitted W of the generic driver
    last = [g[("packed", "2d")]["last_v"] for g in port]
    assert last[0] == last[1] and last[2] == last[3], last
    fit = [g["fit_w"] for g in port]
    assert len(set(fit)) == 1, fit


def test_rank_stages_its_row_half(port):
    n, d = 400, 63
    for r, g in enumerate(port):
        (key, nbytes), = g[("packed", "2d")]["x_bytes"].items()
        assert key == repr(("X", "rows", 2, r % 2)), key
        assert abs(nbytes - n * d * 4 / 2) <= d * 4, nbytes
        # the whole table on the 1-D mesh
        assert g[("packed", "1d")]["x_bytes"] == {repr(("X",)): n * d * 4}


def test_coordinator_mesh_reaches_the_executor_on_every_rank(port):
    """``MLTaskManager(coordinator=Coordinator(mesh=...))`` in direct mode on
    each rank of the 2-D mesh: the mesh is the executor's, the rank's
    device the coordinator's, every rank reports the same scores, each
    within 2e-3 of the same search without a mesh."""
    jobs = [g["manager"] for g in port]
    for job in jobs:
        assert job["executor_mesh"] and job["device"] == "cpu"
        assert job["status"] == "completed"
        assert job["scores"] == jobs[0]["scores"] and job["best"] == jobs[0]["best"]
    solo = jobs[0]["solo"]
    assert solo.keys() == jobs[0]["scores"].keys() and len(solo) == len(C_GRID)
    for k, v in solo.items():
        assert jobs[0]["scores"][k] == pytest.approx(v, abs=TOL), k


def test_coordinator_refuses_mesh_with_executor():
    from cs230_distributed_machine_learning_tpu_torch.parallel.mesh import TrialMesh
    from cs230_distributed_machine_learning_tpu_torch.runtime.coordinator import Coordinator
    from cs230_distributed_machine_learning_tpu_torch.runtime.executor import LocalExecutor

    cpu = torch.device("cpu")
    mesh = TrialMesh(group=None, world_size=1, rank=0, device=cpu)
    with pytest.raises(ValueError, match="mesh= or executor="):
        Coordinator(mesh=mesh, executor=LocalExecutor(cpu))
    coord = Coordinator(mesh=mesh)
    assert coord.executor.mesh is mesh and coord.device == cpu
