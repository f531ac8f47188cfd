"""Every model family on a trial mesh of the port, against the JAX
package's mesh run of ``tests/test_mesh_families.py`` and the port's
one-rank run, on the CPU.

One spawn of 2 gloo ranks builds a ``data_parallel=2`` mesh (1 trial x 2
data): a bucket that is not LogisticRegression's runs on its flat trial
axis of both ranks with the whole table, as the JAX package's chunked
protocol runs replicated. Each rank runs every case of the JAX test
(RandomForest, GradientBoosting, KNN, MLP, SVC) plus GaussianNB on that
mesh; rank 0 also runs each without a mesh. Scores within 5e-3 of the
JAX package's 8-device mesh run (that test's tolerance) and within 1e-6
of the port's one-rank run; both ranks report the same scores. The
chunked-forest case (``CS230_TREE_CHUNK_MACS=1e5``: several dispatches
of the chunked protocol, the trial-sharded state carried between them)
is within 1e-5 of the one-rank unchunked run, as that test holds the JAX
package. Every spawn, join and wait has a timeout.
"""

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu.models.base import TrialData as JaxData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops.folds import build_split_plan as jax_plan
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jax_trial_map
from cs230_distributed_machine_learning_tpu.parallel.mesh import trial_mesh as jax_mesh

torch.set_num_threads(1)

TIMEOUT_S = 240
RANKS = 2

#: tests/test_mesh_families.py:31-43, plus GaussianNB
FAMILIES = [
    ("RandomForestClassifier", "clf",
     [{"n_estimators": 8, "max_depth": 3, "random_state": 0},
      {"n_estimators": 16, "max_depth": 4, "random_state": 0}]),
    ("GradientBoostingRegressor", "reg",
     [{"n_estimators": 8, "max_depth": 2, "learning_rate": 0.1},
      {"n_estimators": 8, "max_depth": 2, "learning_rate": 0.3}]),
    ("KNeighborsClassifier", "clf", [{"n_neighbors": 3}, {"n_neighbors": 7}]),
    ("MLPClassifier", "clf",
     [{"hidden_layer_sizes": (16,), "max_iter": 40, "random_state": 0}]),
    ("SVC", "clf", [{"C": 0.5, "kernel": "rbf"}, {"C": 5.0, "kernel": "rbf"}]),
    ("GaussianNB", "clf", [{"var_smoothing": 1e-9}, {"var_smoothing": 1e-2}]),
]
CHUNKED = [{"n_estimators": 12, "max_depth": 4, "random_state": s} for s in range(8)]


def _toy():
    """tests/test_mesh_families.py's toy data, draw for draw."""
    rng = np.random.RandomState(1)
    X = rng.randn(160, 6).astype(np.float32)
    yc = (X[:, 0] + 0.3 * rng.randn(160) > 0).astype(np.int32)
    yr = (X[:, 0] * 2 + X[:, 1]).astype(np.float32)
    return X, yc, yr


def _rank(rank, address, q):
    import os

    torch.set_num_threads(1)
    from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.parallel import distributed as D
    from cs230_distributed_machine_learning_tpu_torch.parallel.mesh import trial_mesh
    from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import run_trials

    cpu = torch.device("cpu")
    out = {}
    try:
        D.init_distributed(address, RANKS, rank, device="cpu", timeout_s=TIMEOUT_S)
        mesh = trial_mesh(device="cpu", data_parallel=2)
        X, yc, yr = _toy()
        sets = {"clf": (TrialData(X=X, y=yc, n_classes=2),
                        build_split_plan(yc, task="classification", n_folds=3)),
                "reg": (TrialData(X=X, y=yr, n_classes=0),
                        build_split_plan(yr, task="regression", n_folds=3))}

        def scores(run):
            return [m["mean_cv_score"] for m in run.trial_metrics]

        for name, kind, params in FAMILIES:
            data, plan = sets[kind]
            kernel = get_kernel(name)
            out[name] = {"mesh": scores(run_trials(kernel, data, plan, params, device=cpu,
                                                   mesh=mesh))}
            if rank == 0:
                out[name]["solo"] = scores(run_trials(kernel, data, plan, params, device=cpu))
        data, plan = sets["clf"]
        kernel = get_kernel("RandomForestClassifier")
        if rank == 0:
            out["chunked_solo"] = scores(run_trials(kernel, data, plan, CHUNKED, device=cpu))
        os.environ["CS230_TREE_CHUNK_MACS"] = "1e5"  # several chunks
        run = run_trials(kernel, data, plan, CHUNKED, device=cpu, mesh=mesh)
        out["chunked"] = {"mesh": scores(run), "n_dispatches": run.n_dispatches}
        q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback

        q.put((rank, traceback.format_exc() + repr(e)))
    finally:
        D.shutdown()


@pytest.fixture(scope="module")
def port():
    import torch.multiprocessing as mp

    from cs230_distributed_machine_learning_tpu_torch.runtime.fleet import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, address, q), daemon=True)
             for r in range(RANKS)]
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


@pytest.mark.parametrize("name,kind,params", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_on_a_2d_mesh_matches_jax_mesh_and_one_rank(port, name, kind, params):
    X, yc, yr = _toy()
    y = yc if kind == "clf" else yr
    data = JaxData(X=X, y=y, n_classes=2 if kind == "clf" else 0)
    plan = jax_plan(y, task="classification" if kind == "clf" else "regression", n_folds=3)
    ref = jax_trial_map.run_trials(jax_kernel(name), data, plan, params, mesh=jax_mesh())
    ref = [m["mean_cv_score"] for m in ref.trial_metrics]
    got = port[0][name]["mesh"]
    print(name, "port 2-rank mesh", got, "JAX 8-device mesh", ref)
    assert port[1][name]["mesh"] == got
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)
    np.testing.assert_allclose(got, port[0][name]["solo"], atol=1e-6, rtol=0)


def test_chunked_forest_on_a_2d_mesh_matches_one_rank(port):
    got = port[0]["chunked"]
    assert got["n_dispatches"] > 2  # really went through the chunked path
    assert port[1]["chunked"]["mesh"] == got["mesh"]
    np.testing.assert_allclose(got["mesh"], port[0]["chunked_solo"], atol=1e-5, rtol=0)
