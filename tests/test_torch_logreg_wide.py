"""The port's LogReg packed path at every shape the JAX package takes it.

The JAX package sends every nesterov bucket with ``dpp = ceil(d + 2, 64)
<= 512`` down its packed path, whatever the classes
(``models/logistic.py:251``). The port now does the same: B2 (the fused
step) where B1 / B2 have a register-resident geometry, elsewhere B1's wide
form plus the update in tensor ops, as the JAX package runs B1 plus XLA's
update past its VMEM gate. B3 takes any number of classes.

On the CPU the kernels run as their plain versions (``CS230_FORCE_PACKED=1``
takes the packed path and B3's wrapper); the JAX package runs its Pallas
kernels in interpret mode (``CS230_PALLAS_INTERPRET=1``), as
``tests/test_torch_main_path.py`` does. Searches are held to the JAX
package within 2e-3 (the bf16 Gram products), ``best_params_`` equal unless
the JAX package's top two scores are that close. The wide form itself is
held against its plain version on the card (``tests/test_torch_kernels_gpu.py``).
"""

import json

import numpy as np
import pytest
import torch
from scipy.stats import loguniform
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import RandomizedSearchCV

from cs230_distributed_machine_learning_tpu import MLTaskManager as JaxManager
from cs230_distributed_machine_learning_tpu.models.registry import get_kernel as jax_kernel
from cs230_distributed_machine_learning_tpu_torch import MLTaskManager as TorchManager
from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel as torch_kernel
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as tk
from cs230_distributed_machine_learning_tpu_torch.parallel import trial_map
from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

SEARCH_TOL = 2e-3

# The tensors here are small: one intra-op thread each, so that parallel
# test workers do not oversubscribe the host's cores with idle spinning.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _torch_storage(tmp_path):
    """The port's storage root in a per-test tmpdir (conftest does the same
    for the JAX package)."""
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path / "tpuml_torch")
    tcfg.set_config(cfg)
    yield
    tcfg.set_config(tcfg.FrameworkConfig.load(env={}))


# ------------------------------------------------------------------ the gate

GATE_CLASSES = [*range(2, 21), 26, 100, 300]


@pytest.mark.parametrize("c", GATE_CLASSES)
def test_packed_gate_equals_the_jax_packages(monkeypatch, c):
    """Forced on the CPU in both packages, the port's batched_applicable is
    the JAX package's at every dpp 64-576 (d = dpp - 2): nesterov up to 512
    padded features, whatever the classes; Newton never. On the card the
    port also needs n >= 4096 rows, as JAX on the TPU."""
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    monkeypatch.setenv("CS230_PALLAS_INTERPRET", "1")
    jk, pk = jax_kernel("LogisticRegression"), torch_kernel("LogisticRegression")
    for dpp in range(64, 577, 64):
        d = dpp - 2
        for method in ("nesterov", "newton"):
            static = {"_method": method, "_n_classes": c, "fit_intercept": True}
            want = jk.batched_applicable(static, 5000, d)
            assert pk.batched_applicable(static, 5000, d, CPU) == want, (dpp, c, method)
            assert want == (method == "nesterov" and dpp <= 512)
    monkeypatch.delenv("CS230_FORCE_PACKED")
    static = {"_method": "nesterov", "_n_classes": c, "fit_intercept": True}
    cuda = torch.device("cuda")
    assert pk.batched_applicable(static, 4096, 510, cuda)
    assert not pk.batched_applicable(static, 4095, 510, cuda)
    assert not pk.batched_applicable(static, 4096, 511, cuda)
    assert not pk.batched_applicable(static, 116_202, 54, CPU)


# ------------------------------------------------ searches at the gap shapes


def _by_params(status):
    return {json.dumps(r["search_params"], sort_keys=True): r["mean_cv_score"]
            for r in status["job_result"]["results"]}


def _assert_close_searches(js, ts):
    """Every mean_cv_score within SEARCH_TOL; best_params_ equal unless the
    JAX package's top two scores are within it."""
    assert js["job_status"] == ts["job_status"] == "completed"
    jr, tr = _by_params(js), _by_params(ts)
    assert jr.keys() == tr.keys()
    worst = max(abs(jr[k] - tr[k]) for k in jr)
    assert worst <= SEARCH_TOL, worst
    top = sorted(jr.values(), reverse=True)
    if len(top) < 2 or top[0] - top[1] > SEARCH_TOL:
        assert (ts["job_result"]["best_result"]["search_params"]
                == js["job_result"]["best_result"]["search_params"])


def _count_calls(monkeypatch, names):
    """Count the port's calls of the named kernel wrappers (plain versions
    on the CPU) without changing what they compute."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tk, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tk, name, counted)
    return calls


# (dataset, max_iter, the body the port runs), each table nesterov's (its
# (d + 1) c past Newton's 512): a cell with a register-resident geometry
# the first kernels' rule refused (dpp 192, 7 classes -> B2), a wide cell
# (dpp 320, 10 classes -> B1's wide form + the update) and a cell past 16
# classes (dpp 64, 20 classes -> the wide form)
GAP_SEARCHES = {
    "geo_dpp192_c7": ("synthetic_512x150x7", 10, "packed_nesterov_step"),
    "wide_dpp320_c10": ("synthetic_512x300x10", 10, "packed_softmax_grad"),
    "wide_dpp64_c20": ("synthetic_512x40x20", 20, "packed_softmax_grad"),
}


@pytest.mark.parametrize("tag", sorted(GAP_SEARCHES))
def test_packed_search_at_a_gap_shape_matches_jax(monkeypatch, tag):
    """128 trials through both managers, forced onto the packed path: the
    JAX package's Pallas kernels in interpret mode (B1 and XLA's update at
    these widths), the port's plain versions. The port runs the body
    the gate's rule picks, one call a solver step, and the other never."""
    dataset, max_iter, body = GAP_SEARCHES[tag]
    monkeypatch.setenv("CS230_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    search = RandomizedSearchCV(
        LogisticRegression(max_iter=max_iter),
        {"C": loguniform(1e-2, 1e2), "tol": [1e-4]},
        n_iter=128, cv=3, random_state=0,
    )
    js = JaxManager().train(search, dataset, {"random_state": 42}, show_progress=False)
    calls = _count_calls(monkeypatch, ("packed_softmax_grad", "packed_nesterov_step"))
    ts = TorchManager(device="cpu").train(search, dataset, {"random_state": 42})
    assert len(ts["job_result"]["results"]) == 128
    _assert_close_searches(js, ts)
    other = ({"packed_softmax_grad", "packed_nesterov_step"} - {body}).pop()
    assert calls[body] == max_iter and calls[other] == 0, calls


def test_scored_search_past_256_classes_matches_jax(monkeypatch):
    """A neg_log_loss search on 300 classes: the generic nesterov driver in
    both packages, the port's gradient through B3's wrapper (classes padded
    to 304, the class-tiled kernel on the card, the plain version here),
    the JAX package's its fused-mask XLA formulation: every mean_cv_score
    within 2e-3."""
    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    search = RandomizedSearchCV(
        LogisticRegression(max_iter=20), {"C": loguniform(1e-2, 1e1)},
        n_iter=4, cv=3, random_state=0, scoring="neg_log_loss",
    )
    dataset = "synthetic_1800x20x300"
    js = JaxManager().train(search, dataset, {"random_state": 42}, show_progress=False)
    calls = _count_calls(monkeypatch, ("masked_softmax_grad", "packed_softmax_grad",
                                       "packed_nesterov_step"))
    ts = TorchManager(device="cpu").train(search, dataset, {"random_state": 42})
    assert all(r["mean_cv_score"] < 0 for r in ts["job_result"]["results"])
    _assert_close_searches(js, ts)
    assert calls == {"masked_softmax_grad": 20, "packed_softmax_grad": 0,
                     "packed_nesterov_step": 0}, calls


# ------------------------------------------------- the wide form's plan


@pytest.mark.parametrize("shape", [
    (20_480, 448, 10, 6, 2), (20_480, 320, 100, 6, 1), (2048, 64, 20, 3, 1),
    (116_736, 64, 7, 6, 8), (8192, 128, 300, 4, 1), (16_384, 64, 1000, 1, 1),
    (20_480, 512, 1000, 6, 6), (1_000_064, 512, 1000, 6, 1), (64, 16, 2, 1, 1),
])
def test_wide_plan_covers_rows_and_lanes_within_the_scratch_cap(shape):
    """Every launch's scratch (W^T, R^T of its rows, its P partials) fits
    2 GiB and the plan's buffer; the launches cover every (lane block, row
    tile) once, each lane group's row chunks in order from tile 0 (so the
    first writes and the rest add); the pass (a) CTAs fit shared memory."""
    n_pad, dpp, c, S, n_wb = shape
    plan = tk.wide_plan(*shape)
    assert plan is not None and plan["cpp"] == tk.class_pitch(c) >= c
    assert plan["scratch"] <= tk.WIDE_SCRATCH_BYTES
    assert plan["smem_a"] <= tk.SMEM_LIMIT and plan["smem_b"] <= tk.SMEM_LIMIT
    if plan["cpp"] <= tk.CLASS_TILE:
        assert (plan["na"], plan["cpp"]) in tk.WIDE_GEOMETRIES
    T, Tw = -(-n_pad // tk.MASKED_ROWS), tk.TRIAL_BLOCK
    assert plan["row_tiles"] == T and plan["n_lb"] == n_wb * S
    seen = np.zeros((n_wb * S, T), np.int32)
    first_tile = {}
    for i in range(plan["launches"]):
        lb0, lb1, t0, t1 = tk.wide_launch(plan, i)
        assert 0 < lb1 - lb0 <= plan["lb"] and 0 < t1 - t0 <= plan["tiles"]
        assert plan["ranges"] <= t1 - t0
        seen[lb0:lb1, t0:t1] += 1
        if lb0 not in first_tile:
            first_tile[lb0] = t0
            assert t0 == 0  # the lane group's first launch writes
        cols = (lb1 - lb0) * Tw * plan["cpp"]
        r_off, part_off, total = tk._wide_bytes(dpp, cols, t1 - t0, plan["ranges"])
        assert r_off <= plan["r_offset"] and part_off <= plan["part_offset"]
        assert total <= plan["scratch"]
        assert plan["part_offset"] + plan["ranges"] * dpp * cols * 4 <= plan["scratch"]
    assert (seen == 1).all()


def test_wide_plan_refuses_what_the_kernels_do_not_take():
    """None past dpp 512 (the packed path's cap), off the 16-feature grid,
    below two classes, and for a trial block the kernels do not tile."""
    assert tk.wide_plan(2048, 576, 10, 6, 1) is None
    assert tk.wide_plan(2048, 520, 10, 6, 1) is None
    assert tk.wide_plan(2048, 72, 10, 6, 1) is None
    assert tk.wide_plan(2048, 64, 1, 6, 1) is None
    assert tk.wide_plan(2048, 64, 10, 6, 1, Tw=8) is None
    assert tk.wide_plan(2048, 512, 10, 6, 1) is not None


def test_wide_plan_splits_the_c100_probe_over_launches():
    """chip_smoke.py's probe_c100 shape: its padded residual (4.0 GB) passes
    the cap, so its six lane blocks go in two launches of three."""
    plan = tk.wide_plan(20_480, 320, 100, 6, 1)
    assert (plan["lane_launches"], plan["row_launches"], plan["lb"]) == (2, 1, 3)
    assert 98_304 * 20_480 * 2 > tk.WIDE_SCRATCH_BYTES


# --------------------------------------------------- the packed chunk's memory


@pytest.mark.parametrize("d,c,blocks", [(54, 7, 8), (384, 10, 8), (256, 100, 8),
                                        (500, 1000, 3)])
def test_packed_chunk_is_bounded_by_device_memory(monkeypatch, d, c, blocks):
    """On an 80 GB card the packed chunk keeps its 8 blocks (1024 trials)
    while W, Wp, V, G, the eval's logits of a row chunk and the wide form's
    scratch (the fused form's row-range partials or the two passes' buffer)
    fit half the card; at 1000 classes on 500 features (dpp 512, S
    6: 12.6 GB a tensor at 8 blocks) it drops to the blocks that fit. Half
    the card's share on a rank that shares it halves the budget."""
    monkeypatch.setattr(trial_map, "_device_memory_mb", lambda device: 80_000.0)
    kernel = torch_kernel("LogisticRegression")
    static = {"_method": "nesterov", "_n_classes": c, "fit_intercept": True}
    n, S = 116_202, 6
    got = trial_map._packed_block_cap(kernel, static, n, d, c, S, CPU, 1, 8)
    assert got == blocks
    budget = 0.5 * 80_000 * 1e6
    assert kernel.batched_memory_bytes(static, n, d, c, S, got) <= budget
    if got < 8:
        assert kernel.batched_memory_bytes(static, n, d, c, S, got + 1) > budget
        assert trial_map._packed_block_cap(kernel, static, n, d, c, S, CPU, 2, 8) < got
    dpp, NB = -(-(d + 2) // 64) * 64, c * S * 128
    want = 16 * got * dpp * NB + 4 * got * 2048 * NB
    n_pad = -(-n // 2048) * 2048
    route = tk.route_plan(n_pad, dpp, c, S, got)[0]
    if route == "fused":
        want += tk.fused_plan(n_pad, dpp, c, S, got)["scratch"]
    elif route == "two_pass":
        want += tk.wide_plan(n_pad, dpp, c, S, got)["scratch"]
    assert kernel.batched_memory_bytes(static, n, d, c, S, got) == want
