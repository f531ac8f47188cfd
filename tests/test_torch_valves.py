"""The JAX package's remaining valves in the port, on the CPU, against the
JAX package where it computes something:

- ``CS230_LOG_JSON=1`` and ``get_logger(log_dir=...)``: the JSON formatter
  stamps the active trace and span ids and serializes exceptions, the env
  var opts a fresh logger into it (the three cases of
  ``tests/test_cost_health.py:416-470``), and the daily file handler keeps
  7 backups; a record's line has the JAX formatter's keys and values.
- ``CS230_SVM_KMEANS_ITERS``: the port's k-means landmarks after 3 Lloyd
  iterations within 1e-4 relative of the JAX ``_kmeans_landmarks`` (one
  row chunk and several), and a Nyström SVC search with the valve on
  within 2e-3 of the JAX package's.
- ``CS230_DEEP_WSCHED`` / ``CS230_DEEP_NBSCHED``: a deep tree under both
  sweep hooks equal to the JAX package's under the same env, the hooks
  taking precedence over the static schedules, and both in the tree
  kernels' ``trace_salt``.
- ``CS230_HIST_COMPACT=1`` (with ``CS230_HIST_BLOCK_ROWS`` / ``_NODES``):
  the port's level histogram equals the JAX ``_level_histogram_compact``
  to the bit at the four slot patterns of ``tests/test_trees.py:315``.
- ``CS230_AOT_DIR``: the kernel libraries' build directory and
  ``aot_cache.cache_dir()`` follow it.
"""

import json
import logging
import sys
from logging.handlers import TimedRotatingFileHandler

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.models import svm as jsvm
from cs230_distributed_machine_learning_tpu.models.base import TrialData as JData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.ops import trees as jt
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jtm
from cs230_distributed_machine_learning_tpu.utils import logging as jlog
from cs230_distributed_machine_learning_tpu_torch.models import svm as tsvm
from cs230_distributed_machine_learning_tpu_torch.models import trees as tmt
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.obs.tracing import activate, span
from cs230_distributed_machine_learning_tpu_torch.ops import trees as tt
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map as tm
from cs230_distributed_machine_learning_tpu_torch.utils import logging as tlog
from cs230_distributed_machine_learning_tpu_torch.utils import prng

torch.set_num_threads(1)
CPU = torch.device("cpu")
KMEANS_RTOL = 1e-4
SVC_SEARCH_TOL = 2e-3


# ---------------- JSON logs ----------------


def _record(msg, level=logging.INFO, exc_info=None):
    return logging.LogRecord("tpuml.test", level, __file__, 1, msg, (), exc_info, func="emit")


def test_json_formatter_stamps_trace_and_span_ids():
    fmt = tlog.JsonFormatter()

    def emit(msg):
        return json.loads(fmt.format(_record(msg)))

    with activate("feedbead00000000"):
        with span("log.parent") as sp:
            line = emit("inside span")
            assert line["trace_id"] == "feedbead00000000"
            assert line["span_id"] == sp.span_id
            assert line["msg"] == "inside span"
            assert line["level"] == "INFO"
            assert line["logger"] == "tpuml.test" and line["func"] == "emit"
    outside = emit("outside")
    assert "trace_id" not in outside and "span_id" not in outside
    rec = _record("same keys")
    assert json.loads(fmt.format(rec)) == json.loads(jlog.JsonFormatter().format(rec))


def test_json_formatter_serializes_exceptions():
    try:
        raise ValueError("kaput")
    except ValueError:
        rec = _record("boom", logging.ERROR, sys.exc_info())
    line = json.loads(tlog.JsonFormatter().format(rec))
    assert "ValueError: kaput" in line["exc"]


def test_json_formatter_never_raises_on_a_broken_tracer(monkeypatch):
    from cs230_distributed_machine_learning_tpu_torch.obs import tracing

    def broken():
        raise RuntimeError("no context")

    monkeypatch.setattr(tracing, "current_trace_id", broken)
    line = json.loads(tlog.JsonFormatter().format(_record("still logged")))
    assert line["msg"] == "still logged" and "trace_id" not in line


def test_get_logger_opts_into_json_via_env(monkeypatch):
    monkeypatch.setenv("CS230_LOG_JSON", "1")
    logger = tlog.get_logger("tpuml.torch_jsontest")  # fresh name -> configured now
    assert any(isinstance(h.formatter, tlog.JsonFormatter) for h in logger.handlers)
    monkeypatch.setenv("CS230_LOG_JSON", "0")
    plain = tlog.get_logger("tpuml.torch_plaintest")
    assert not any(isinstance(h.formatter, tlog.JsonFormatter) for h in plain.handlers)


def test_get_logger_writes_a_daily_file_with_seven_backups(monkeypatch, tmp_path):
    monkeypatch.setenv("CS230_LOG_JSON", "1")
    logger = tlog.get_logger("tpuml.torch_filetest", log_dir=str(tmp_path / "logs"))
    (fh,) = [h for h in logger.handlers if isinstance(h, TimedRotatingFileHandler)]
    assert fh.backupCount == 7 and fh.when == "MIDNIGHT"
    with activate("0123456789abcdef"):
        logger.info("to the file")
    fh.flush()
    lines = (tmp_path / "logs" / "app.log").read_text().splitlines()
    assert [json.loads(ln)["msg"] for ln in lines] == ["to the file"]
    assert json.loads(lines[0])["trace_id"] == "0123456789abcdef"
    assert tlog.get_logger("tpuml.torch_filetest") is logger  # configured once
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


# ---------------- k-means Nyström landmarks ----------------


@pytest.mark.parametrize("chunk", [16384, 700])
def test_kmeans_landmarks_match_jax(chunk):
    rng = np.random.RandomState(5)
    centers = rng.randn(6, 5).astype(np.float32) * 3.0
    X = (centers[rng.randint(0, 6, 2500)] + rng.randn(2500, 5)).astype(np.float32)
    init = X[np.random.RandomState(17).choice(2500, 40, replace=False)]
    want = np.asarray(jsvm._kmeans_landmarks(jnp.asarray(X), jnp.asarray(init), 3, chunk))
    got = tsvm._kmeans_landmarks(torch.as_tensor(X), torch.as_tensor(init), 3, chunk).numpy()
    assert not np.allclose(got, init)  # the iterations moved the centers
    np.testing.assert_allclose(got, want, rtol=KMEANS_RTOL, atol=KMEANS_RTOL * np.abs(want).max())


def test_nystrom_svc_search_with_kmeans_landmarks_matches_jax(monkeypatch):
    for mod in (jsvm, tsvm):
        monkeypatch.setattr(mod, "_MAX_N", 500)
    monkeypatch.setenv("CS230_SVM_NYSTROM_M", "64")
    monkeypatch.setenv("CS230_SVM_NYSTROM_STEPS", "300")
    rng = np.random.RandomState(2)
    X = rng.randn(700, 6).astype(np.float32)
    y = (np.argmax(X[:, :3] + 0.3 * rng.randn(700, 3), axis=1)).astype(np.int32)
    plan = build_split_plan(y, task="classification", n_folds=2)
    params = [{"C": 0.5}, {"C": 2.0}]
    scores = {}
    for iters in ("0", "3"):
        monkeypatch.setenv("CS230_SVM_KMEANS_ITERS", iters)
        jtm._compiled_cache.clear()
        port = tm.run_trials(get_kernel("SVC"), TrialData(X=X, y=y, n_classes=3), plan, params,
                             device=CPU)
        ref = jtm.run_trials(jax_kernel("SVC"), JData(X=X, y=y, n_classes=3), plan, params)
        for m, r in zip(port.trial_metrics, ref.trial_metrics):
            assert abs(m["mean_cv_score"] - r["mean_cv_score"]) <= SVC_SEARCH_TOL, (iters, m, r)
            assert abs(m["accuracy"] - r["accuracy"]) <= SVC_SEARCH_TOL, (iters, m, r)
        scores[iters] = [m["cv_scores"] for m in port.trial_metrics]
    jtm._compiled_cache.clear()
    assert scores["0"] != scores["3"]  # the landmarks changed the features


# ---------------- the tree valves ----------------


def _deep_inputs():
    rng = np.random.RandomState(2)
    n, k = 700, 3
    X = rng.randn(n, 6).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.7 * rng.randn(n, k), axis=1)
    xb = np.asarray(jt.bin_data(X, jt.quantile_bins(X, 16)))
    w = (rng.rand(2, n) > 0.25).astype(np.float32)
    S = np.eye(k, dtype=np.float32)[y][None] * w[..., None]
    return xb, S, w


def _deep_pair(jax_side=True, **kw):
    xb, S, C = _deep_inputs()
    kw = dict(levels=6, width=8, n_bins=16, min_samples_leaf=1.0, count_from_stats=True, **kw)
    ttree = tt.build_tree_deep(torch.as_tensor(xb), torch.as_tensor(S), torch.as_tensor(C),
                               key=prng.PRNGKey(5), **kw)
    if not jax_side:
        return None, ttree
    jfit = jax.jit(jax.vmap(
        lambda s, c: jt.build_tree_deep(jnp.asarray(xb), s, c, key=jax.random.PRNGKey(5),
                                        precision=None, **kw)))
    return jfit(jnp.asarray(S), jnp.asarray(C)), ttree


def _equal(jtree, ttree):
    assert set(ttree) == set(jtree)
    for name in jtree:
        np.testing.assert_array_equal(np.asarray(jtree[name]), ttree[name].numpy(),
                                      err_msg=name)


def test_deep_tree_sweep_hooks_match_jax(monkeypatch):
    _, base_t = _deep_pair(False, w_schedule=(8, 3, 4), nb_schedule=(8, 4))
    monkeypatch.setenv("CS230_DEEP_WSCHED", "8:2:2")
    monkeypatch.setenv("CS230_DEEP_NBSCHED", "4:8")
    # the hooks win over the static schedules passed in
    jtree, ttree = _deep_pair(w_schedule=(8, 3, 4), nb_schedule=(8, 4))
    _equal(jtree, ttree)
    _equal(*_deep_pair())
    assert ttree["level_ids"].shape[-1] == 8
    assert not all(torch.equal(ttree[k], base_t[k]) for k in ttree)
    salts = {}
    for wsched in ("", "8:2:2"):
        monkeypatch.setenv("CS230_DEEP_WSCHED", wsched)
        salts[wsched] = tmt.RandomForestClassifierKernel().trace_salt()
    assert salts[""] != salts["8:2:2"] and "4:8" in salts[""]


@pytest.mark.parametrize("mode", range(4))
def test_level_histogram_under_hist_compact_equals_jax_compact(monkeypatch, mode):
    """``tests/test_trees.py:315``'s patterns (geometry cut to 256 rows and
    16 nodes a block in both packages): the port's level histogram, with
    the compact valve on, equals the JAX compact histogram and the JAX
    dense one to the bit."""
    import cs230_distributed_machine_learning_tpu.ops.trees as ot

    monkeypatch.setattr(ot, "_COMPACT_R", 256)
    monkeypatch.setattr(ot, "_COMPACT_M", 16)
    monkeypatch.setenv("CS230_HIST_COMPACT", "1")
    monkeypatch.setenv("CS230_HIST_BLOCK_ROWS", "256")
    monkeypatch.setenv("CS230_HIST_BLOCK_NODES", "16")
    rng = np.random.RandomState(7 + mode)
    n, d, nb, W, kk = 4097, 6, 32, 70, 3
    if mode == 0:
        slot = rng.randint(0, W + 1, n)
    elif mode == 1:  # few huge nodes + sparse tail
        slot = np.where(rng.rand(n) < 0.7, rng.randint(0, 2, n), rng.randint(0, W + 1, n))
    elif mode == 2:  # mostly dead rows
        slot = np.where(rng.rand(n) < 0.85, W, rng.randint(0, W, n))
    else:  # every node singleton-ish
        slot = np.arange(n) % (W + 1)
    xb = rng.randint(0, nb, (n, d)).astype(np.int32)
    SC = rng.randint(0, 5, (n, kk)).astype(np.float32)
    compact = np.asarray(ot._level_histogram_compact(
        jnp.asarray(slot), jnp.asarray(xb), jnp.asarray(SC), W, nb, None))
    dense = np.asarray(ot._level_histogram(
        jnp.asarray(slot), jnp.asarray(xb), jnp.asarray(SC), W, nb, None))
    (port,) = tt._level_histogram_multi(
        torch.as_tensor(slot, dtype=torch.int32)[None], (torch.as_tensor(xb),),
        torch.as_tensor(SC)[None], W, (nb,), integer_stats=True)
    np.testing.assert_array_equal(port[0].numpy(), compact)
    np.testing.assert_array_equal(compact, dense)


# ---------------- CS230_AOT_DIR ----------------


def test_aot_dir_moves_the_kernel_libraries(monkeypatch, tmp_path):
    from cs230_distributed_machine_learning_tpu_torch.ops import cuda_build
    from cs230_distributed_machine_learning_tpu_torch.utils import aot_cache

    monkeypatch.delenv("CS230_AOT_DIR", raising=False)
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR
    assert cuda_build.BUILD_DIR.parts[-2:] == ("csrc", "build")
    assert aot_cache.cache_dir() == str(cuda_build.BUILD_DIR)
    monkeypatch.setenv("CS230_AOT_DIR", str(tmp_path / "aot"))
    assert cuda_build.build_dir() == tmp_path / "aot"
    assert aot_cache.cache_dir() == str(tmp_path / "aot")
    assert cuda_build.library_path("logreg").parent == tmp_path / "aot"
    assert aot_cache._prune_stale_generations(max_age_s=0.0) == 0  # no directory yet
