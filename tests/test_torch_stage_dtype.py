"""Compressed staging (``CS230_STAGE_DTYPE`` = bf16 / int8 / auto) in the
port's trial engine against the JAX package's, on the CPU, fed the same
numpy inputs.

- The host-side compressed forms (``stage_compress``, data/stage_codec.py)
  and the decoded matrix (``stage_decode``) equal the JAX package's
  ``_stage_compress`` / ``_stage_decode`` to the bit.
- Searches staged in bf16 and in int8 score within 5e-3 and 2e-2 of the
  JAX package's run in the same mode (its own limits against f32 staging,
  ``tests/test_packed_parity.py``): the packed LogReg path
  (``CS230_FORCE_PACKED=1`` here; the JAX side through its kernels' plain
  references), the generic nesterov driver, and a streamed LogReg under a
  small stage budget.
- The staged X carries its mode in its key and holds a half (bf16) or a
  quarter plus the scale vector (int8) of the f32 bytes; the packed path's
  staged extras and the stream's blocks carry the mode too, and the padded
  bf16 A from a bf16-staged X equals the f32 staging's to the bit.
- ``auto``: a pinned 5 MB/s link gives bf16, 500 MB/s f32, and a CPU device
  (no pin) f32, as in the JAX package's ``tests/test_stage_cache.py:257``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cs230_distributed_machine_learning_tpu.data import stage_cache as jsc
from cs230_distributed_machine_learning_tpu.models.base import TrialData as JData
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu.parallel import trial_map as jtm
from cs230_distributed_machine_learning_tpu_torch.data import stage_cache as sc
from cs230_distributed_machine_learning_tpu_torch.data import stage_codec as codec
from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map as tm

torch.set_num_threads(1)
CPU = torch.device("cpu")
#: score limits against the JAX package's run in the same staging mode
TOL = {"bf16": 5e-3, "int8": 2e-2}
VALVES = ("CS230_STAGE_DTYPE", "CS230_STAGE_LINK_MBPS", "CS230_STAGE_AUTO_MBPS",
          "CS230_FORCE_PACKED", "CS230_PALLAS_INTERPRET", "CS230_STREAM",
          "CS230_STREAM_BLOCK_ROWS", "CS230_STAGE_CACHE_MB", "CS230_FUSED_STEP")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in VALVES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CS230_STAGE_CACHE", "1")
    saved = dict(jtm._compiled_cache)
    jtm._compiled_cache.clear()
    sc.STAGE_CACHE.clear()
    jsc.STAGE_CACHE.clear()
    yield
    sc.STAGE_CACHE.clear()
    jsc.STAGE_CACHE.clear()
    jtm._compiled_cache.clear()
    jtm._compiled_cache.update(saved)


def _table(n=900, d=10, c=3, seed=3):
    """Features of mixed scales (a zero column, a wide one) and a label
    with class margins."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[:, 0] = 0.0
    X[:, 1] *= 40.0
    X[:, 2] = np.abs(X[:, 2]) * 1e-3
    W = rng.randn(d, c)
    W[1] /= 40.0
    y = np.argmax(X @ W + 0.5 * rng.randn(n, c), axis=1).astype(np.int32)
    return X, y, c


def _nesterov(monkeypatch, *kernels):
    """Both packages' LogReg on the nesterov solver at any size."""
    for k in kernels:
        orig = k.resolve_static
        monkeypatch.setattr(k, "resolve_static",
                            lambda s, n, d, c, o=orig: {**o(s, n, d, c), "_method": "nesterov"})


def _plain_pallas(monkeypatch):
    """The JAX packed fn through its kernels' plain references."""
    from cs230_distributed_machine_learning_tpu.ops import pallas_logreg as jpl

    def plain(ref):
        return lambda *a, bm=256, interpret=False, **k: ref(*a, **k)

    monkeypatch.setattr(jpl, "packed_nesterov_step", plain(jpl.packed_nesterov_step_reference))
    monkeypatch.setattr(jpl, "packed_softmax_grad", plain(jpl.packed_softmax_grad_reference))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_forms_and_decode_equal_jax(mode):
    X, _, _ = _table()
    X[5, 3] = -0.0
    X[7, 4] = 3.0e38
    form, jform = codec.stage_compress(X, mode), jtm._stage_compress(X, mode)
    assert sorted(form) == sorted(jform)
    if mode == "bf16":
        assert form["bf16"].dtype == torch.bfloat16
        np.testing.assert_array_equal(form["bf16"].view(torch.int16).numpy(),
                                      np.asarray(jform["bf16"]).view(np.int16))
    else:
        assert form["q8"].dtype == np.int8 and form["scale"].dtype == np.float32
        np.testing.assert_array_equal(form["q8"], jform["q8"])
        np.testing.assert_array_equal(form["scale"].view(np.int32),
                                      jform["scale"].view(np.int32))
    decoded = codec.stage_decode(codec.to_device(form, CPU)).numpy()
    jdecoded = np.asarray(jtm._stage_decode(jax.tree_util.tree_map(jnp.asarray, jform)))
    assert decoded.dtype == np.float32 and decoded.shape == X.shape
    np.testing.assert_array_equal(decoded.view(np.int32), jdecoded.view(np.int32))
    np.testing.assert_array_equal(codec.stage_compress(X, "f32"), X)
    assert codec.stage_decode(X) is X


def _runs(monkeypatch, mode, X, y, c, params, n_folds, packed):
    """(the port's trial metrics, the JAX package's) under ``mode``."""
    monkeypatch.setenv("CS230_STAGE_DTYPE", mode)
    if packed:
        monkeypatch.setenv("CS230_FORCE_PACKED", "1")
        monkeypatch.setenv("CS230_PALLAS_INTERPRET", "1")
        _plain_pallas(monkeypatch)
    kern, jkern = get_kernel("LogisticRegression"), jax_kernel("LogisticRegression")
    _nesterov(monkeypatch, kern, jkern)
    plan = build_split_plan(y, task="classification", n_folds=n_folds)
    port = tm.run_trials(kern, TrialData(X=X, y=y, n_classes=c), plan, params, device=CPU)
    ref = jtm.run_trials(jkern, JData(X=X, y=y, n_classes=c), plan, params)
    return port.trial_metrics, ref.trial_metrics


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "generic"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_staged_search_matches_jax_in_the_same_mode(monkeypatch, mode, packed):
    X, y, c = _table()
    params = [{"C": C, "max_iter": 25} for C in (0.1, 1.0, 10.0)]
    port, ref = _runs(monkeypatch, mode, X, y, c, params, 2, packed)
    assert len(port) == len(ref) == 3
    for m, r in zip(port, ref):
        assert abs(m["mean_cv_score"] - r["mean_cv_score"]) <= TOL[mode], (m, r)
        assert abs(m["accuracy"] - r["accuracy"]) <= TOL[mode], (m, r)
    keys = sc.STAGE_CACHE.keys()
    assert any(k[2:] == ("X", mode) for k in keys), keys
    extras = [k for k in keys if "batched_extra" in k]
    assert (len(extras) == 2) == packed and all(k[5] == mode for k in extras), extras


def test_staged_bytes_keys_and_padded_design(monkeypatch):
    """Each mode's X entry under ("X", mode) at its share of the f32 bytes;
    every packed extra keyed by the mode; the padded bf16 A (B2's operand)
    from a bf16-staged X is the f32 staging's to the bit (bf16 rounding is
    idempotent), so the two modes differ only through the Lipschitz bound,
    which is built in f32 from the decoded matrix."""
    X, y, c = _table(n=600)
    n, d = X.shape
    params = [{"C": 1.0, "max_iter": 5}]
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    kern = get_kernel("LogisticRegression")
    _nesterov(monkeypatch, kern)
    data = TrialData(X=X, y=y, n_classes=c)
    plan = build_split_plan(y, task="classification", n_folds=2)
    for mode in ("f32", "bf16", "int8"):
        monkeypatch.setenv("CS230_STAGE_DTYPE", mode)
        tm.run_trials(kern, data, plan, params, device=CPU)
    nbytes = {k[2:]: v for k, v in sc.STAGE_CACHE.nbytes_by_key().items()}
    assert nbytes[("X",)] == n * d * 4
    assert nbytes[("X", "bf16")] == n * d * 2
    assert nbytes[("X", "int8")] == n * d + 4 * d
    ab = {k[5]: v for k, v in sc.STAGE_CACHE.nbytes_by_key().items()
          if "_logreg_ab" in k}
    assert sorted(ab) == ["bf16", "f32", "int8"]
    fp = sc.dataset_fingerprint(data)

    def entry(mode, name):
        (key,) = [k for k in sc.STAGE_CACHE.keys()
                  if k[0] == fp and name in k and k[5] == mode]
        val, _ = sc.STAGE_CACHE.get_or_stage(key, lambda: None)
        return val

    a32, a16 = entry("f32", "_logreg_ab"), entry("bf16", "_logreg_ab")
    assert a32.dtype == a16.dtype == torch.bfloat16
    assert torch.equal(a32.view(torch.int16), a16.view(torch.int16))
    assert not torch.equal(entry("f32", "_logreg_lam_max"), entry("bf16", "_logreg_lam_max"))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_streamed_logreg_under_a_small_budget_matches_jax(monkeypatch, mode):
    """A 0.5 MB stage budget streams the 900 KB table in both packages
    (the port past the whole budget, JAX past half); each block is
    compressed before its upload and carries the mode in its key."""
    X, y, c = _table(n=1500, d=150)
    monkeypatch.setenv("CS230_STAGE_CACHE_MB", "0.5")
    monkeypatch.setenv("CS230_STREAM_BLOCK_ROWS", "512")
    params = [{"C": 1.0, "max_iter": 15}, {"C": 0.1, "max_iter": 15}]
    port, ref = _runs(monkeypatch, mode, X, y, c, params, 2, packed=False)
    for m, r in zip(port, ref):
        assert abs(m["mean_cv_score"] - r["mean_cv_score"]) <= TOL[mode], (m, r)
        assert abs(m["accuracy"] - r["accuracy"]) <= TOL[mode], (m, r)
    blocks = [k for k in sc.STAGE_CACHE.uploads_by_key() if "block" in k]
    assert len(blocks) == 3 and all(mode in k for k in blocks), blocks
    assert not any(k[2:3] == ("X",) for k in sc.STAGE_CACHE.uploads_by_key())


def test_auto_resolution_follows_jax(monkeypatch):
    monkeypatch.setenv("CS230_STAGE_DTYPE", "auto")
    cuda = torch.device("cuda", 0)  # a device object: nothing is launched
    for mbps, want in (("5", "bf16"), ("500", "f32")):
        monkeypatch.setenv("CS230_STAGE_LINK_MBPS", mbps)
        assert tm._resolve_stage_mode(tm._staging_dtype(), cuda) == want
        assert jtm._resolve_stage_mode(jtm._staging_dtype()) == want
    monkeypatch.setenv("CS230_STAGE_AUTO_MBPS", "1000")
    assert tm._resolve_stage_mode("auto", cuda) == "bf16"
    monkeypatch.delenv("CS230_STAGE_AUTO_MBPS")
    monkeypatch.delenv("CS230_STAGE_LINK_MBPS")
    assert tm._measured_link_mbps(CPU) == float("inf")
    assert tm._resolve_stage_mode("auto", CPU) == "f32"
    for raw, want in (("int8", "int8"), ("BF16", "bf16"), ("junk", "f32"), ("f32", "f32")):
        monkeypatch.setenv("CS230_STAGE_DTYPE", raw)
        assert tm._staging_dtype() == jtm._staging_dtype() == want
    # a search under auto on the CPU stages f32
    monkeypatch.setenv("CS230_STAGE_DTYPE", "auto")
    X, y, c = _table(n=300)
    tm.run_trials(get_kernel("LogisticRegression"), TrialData(X=X, y=y, n_classes=c),
                  build_split_plan(y, task="classification", n_folds=2), [{"C": 1.0}],
                  device=CPU)
    assert [k[2:] for k in sc.STAGE_CACHE.keys() if "X" in k] == [("X",)]
