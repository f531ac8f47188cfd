"""The port's mesh collectives (parallel/collectives.py) over 2 gloo ranks
against the JAX functions on the 8-device CPU mesh of the conftest.

Two ranks are spawned once for the module; each rank holds a contiguous
shard of every case's score vector (a rank's mesh device is the CPU) and
computes ``best_trial``, ``topk_trials`` and ``fold_mean_via_psum``; the
results come back by a queue. The JAX side gets the same numpy vectors:
``collectives.best_trial`` on a sharded device array (its collective
path), ``trial_map._chunk_best`` where the vector has NaN or padding
lanes (the engine's rule: non-finite and padding lanes rank last, which
the port's ``best_trial`` keeps), ``topk_trials`` and
``fold_mean_via_psum``. Every process and join has a timeout.
"""

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu_torch.parallel import collectives as tcol

torch.set_num_threads(1)

TIMEOUT_S = 120


def _cases():
    rng = np.random.default_rng(15)
    out = {
        "plain": rng.normal(size=16).astype(np.float32),
        "ties": np.array([0.5, 0.9, 0.1, 0.9, 0.3, 0.9, 0.2, 0.4], np.float32),
        "tie_across_ranks": np.array([0.1, 0.2, 0.3, 0.7, 0.7, 0.1, 0.2, 0.3], np.float32),
        "nan": np.array([0.2, np.nan, 0.8, 0.1, np.nan, 0.8, np.inf, 0.3], np.float32),
        "all_nan": np.full(8, np.nan, np.float32),
        "padding": np.array([0.4, 0.6, 0.5, 0.3, 0.2, 0.1, 0.99, 0.98], np.float32),
    }
    #: valid lanes (the rest are padding) of each case
    valid = {k: len(v) for k, v in out.items()}
    valid["padding"] = 5
    return out, valid


FOLDS = np.array([0.81, 0.77, 0.93, 0.68, 0.88, 0.71, 0.9, 0.85], np.float32)
TOPK = 3


def _rank(rank, port, q):
    torch.set_num_threads(1)
    from cs230_distributed_machine_learning_tpu_torch.parallel import collectives as C
    from cs230_distributed_machine_learning_tpu_torch.parallel.distributed import (
        init_distributed, shutdown)
    from cs230_distributed_machine_learning_tpu_torch.parallel.mesh import trial_mesh

    try:
        init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout_s=TIMEOUT_S)
        mesh = trial_mesh(device="cpu")
        cases, valid = _cases()
        out = {}
        for name, s in cases.items():
            lo, hi = mesh.shard(len(s))
            mask = np.arange(lo, hi) < valid[name]
            out[("best", name)] = C.best_trial(s[lo:hi], mesh, valid_mask=mask, offset=lo)
            if name in ("plain", "ties", "tie_across_ranks"):
                out[("topk", name)] = tuple(a.tolist() for a in
                                            C.topk_trials(s[lo:hi], TOPK, mesh, offset=lo))
        out["fold_mean"] = C.fold_mean_via_psum(FOLDS, mesh)
        q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        q.put((rank, repr(e)))
    finally:
        shutdown()


@pytest.fixture(scope="module")
def ranks():
    import torch.multiprocessing as mp

    from cs230_distributed_machine_learning_tpu_torch.runtime.fleet import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, q), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r, v in got.items():
        assert isinstance(v, dict), f"rank {r}: {v}"
    assert got[0] == got[1], "the ranks disagree"
    return got[0]


def _jax_best(scores, n_valid, mesh):
    """The engine's reduction: ``_chunk_best`` on a [lanes, 1] score chunk
    with no folds (the holdout column is the mean), ``n_valid`` lanes."""
    import jax.numpy as jnp

    from cs230_distributed_machine_learning_tpu.parallel.trial_map import _chunk_best

    fn = _chunk_best(mesh, "trials", len(scores), 1, 0)
    i, s = fn(jnp.asarray(scores[:, None]), jnp.int32(n_valid))
    return int(i), float(s)


@pytest.mark.parametrize("name", ["plain", "ties", "tie_across_ranks", "nan", "all_nan",
                                  "padding"])
def test_best_trial_matches_jax(ranks, name, eight_device_mesh):
    import jax.numpy as jnp

    from cs230_distributed_machine_learning_tpu.parallel import collectives as jcol

    cases, valid = _cases()
    s = cases[name]
    idx, score = ranks[("best", name)]
    ref = _jax_best(s, valid[name], eight_device_mesh)
    assert idx == ref[0]
    assert score == ref[1] or (np.isinf(score) and np.isinf(ref[1]))
    if np.isfinite(s).all() and valid[name] == len(s):
        # the collective path of the JAX best_trial (a device array)
        j_idx, j_score = jcol.best_trial(jnp.asarray(s), eight_device_mesh)
        assert (idx, score) == (j_idx, j_score)
        # and the port's host path on the whole vector
        assert tcol.best_trial(s)[0] == idx


@pytest.mark.parametrize("name", ["plain", "ties", "tie_across_ranks"])
def test_topk_trials_matches_jax(ranks, name, eight_device_mesh):
    from cs230_distributed_machine_learning_tpu.parallel import collectives as jcol

    s = _cases()[0][name]
    idx, vals = ranks[("topk", name)]
    j_idx, j_vals = jcol.topk_trials(s, TOPK, eight_device_mesh)
    assert idx == j_idx.tolist()
    assert np.array_equal(np.asarray(vals, np.float32), j_vals)
    h_idx, h_vals = tcol.topk_trials(s, TOPK)
    assert h_idx.tolist() == idx and np.array_equal(h_vals, j_vals)


def test_fold_mean_via_psum_matches_jax(ranks, eight_device_mesh):
    from cs230_distributed_machine_learning_tpu.parallel import collectives as jcol

    ref = jcol.fold_mean_via_psum(FOLDS, eight_device_mesh)
    assert ranks["fold_mean"] == pytest.approx(ref, abs=1e-6)
    assert ranks["fold_mean"] == pytest.approx(float(FOLDS.mean()), abs=1e-6)


def test_mesh_info_and_shard_bounds():
    """The JAX return shape of ``mesh_info``; a rank's contiguous shard."""
    from cs230_distributed_machine_learning_tpu_torch.parallel.mesh import (
        TrialMesh, effective_mesh, mesh_info)

    assert mesh_info(None) == (1, None)
    m = TrialMesh(group=None, world_size=4, rank=2, device=torch.device("cpu"))
    assert mesh_info(m) == (4, {"trials": 4})
    assert m.shard(16) == (8, 12)
    with pytest.raises(ValueError):
        m.shard(10)
    one = TrialMesh(group=None, world_size=1, rank=0, device=torch.device("cpu"))
    assert effective_mesh(one) is None and effective_mesh(m) is m
