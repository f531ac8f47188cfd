"""The port's CUDA kernels (csrc/logreg.cu, csrc/hist.cu, csrc/mlp.cu,
csrc/knn.cu) against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU with CUDA and is marked ``gpu``; it
skips where CUDA is absent. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerance: 5e-3 of the max for the LogReg kernels, as for the Pallas
kernels against their references (the kernels round the residual to bf16,
the plain versions keep it in f32); the fused step's frozen columns must be
exact, and every LogReg kernel gives the same bits on two launches (fixed
sum orders, no atomics). The level histogram (B4) must be bit-exact for integer stats (int32
accumulation) and within 1e-5 of the max for float stats (f32 atomics in
no fixed order), also at the boosting levels' shapes (168 lanes of
gradient and hessian columns on 116,202 rows). The MLP epoch (B5) and its plain version round the same
operands to bf16 and sum in different orders. Under SGD every state tensor
stays within 5e-3 of its max. Adam divides by the gradient's root mean
square, so a gradient within f32 rounding of zero can take either sign and
move its parameter by up to the learning rate either way, and the next
steps' relu masks follow: Adam's state is held on average (mean |kernel -
plain| within 1e-2 of the mean change of the tensor over the epoch) and
every parameter within 5e-2 of the largest. The KNN top-k (B6) must keep
every distance within 1e-5 of max(qsq + tsq) (the expansion's f32
rounding) and the same neighbour sets wherever the plain k-th and (k+1)-th
distances are further apart than that; on integer data every distance is
exact and the outputs must be equal, ties (lowest index first) and empty
slots (3.4e38, -1) included, with the lists in shared memory (k <= 256)
and in device memory (k 300), at lane groups of 1, 6 and 9 lanes and with
the rows split into ranges whose partial lists are merged. B3 and B6 are
also held at the winner artifact's shapes (one lane: the covertype refit,
the KNN prediction on 40,000 holdout rows), and a LogReg refit on the card
must launch B3 once a solver step and never B1 or B2.
"""

import numpy as np
import pytest
import torch

from cs230_distributed_machine_learning_tpu_torch.ops import cuda_hist as th
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_knn as tn
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_logreg as tk
from cs230_distributed_machine_learning_tpu_torch.ops import cuda_mlp as tm
from cs230_distributed_machine_learning_tpu_torch.ops import kernel_cases as kc

TOL = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-9))


def _fused_step_inputs(dev, c, S, n_wb, n_pad, dpp, seed=0):
    rng = np.random.RandomState(seed)
    B = S * tk.TRIAL_BLOCK
    NB = c * B

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    Ab = f32(rng.randn(n_pad, dpp)).to(torch.bfloat16)
    W = f32(rng.randn(n_wb, dpp, NB) * 0.2)
    Wp = f32(rng.randn(n_wb, dpp, NB) * 0.2)
    y2 = torch.as_tensor(rng.randint(0, c, (n_pad, 1)).astype(np.int32)).to(dev)
    WSP = f32(rng.rand(n_pad, S) > 0.3)
    done = f32(rng.rand(n_wb, B) > 0.7)
    step = f32(0.01 + rng.rand(n_wb, B) * 0.1)
    Cb = f32(0.1 + rng.rand(n_wb, B))
    maxit = f32(np.where(rng.rand(n_wb, B) > 0.5, 100.0, 2.0))
    pen = np.ones((dpp, 1), np.float32)
    pen[-10:] = 0.0
    return Ab, W, Wp, y2, WSP, done, step, Cb, maxit, f32(pen)


@pytest.mark.gpu
@pytest.mark.parametrize("c,S,n_wb", [(7, 6, 2), (2, 3, 1)])
def test_packed_kernels_match_plain_on_card(cuda, c, S, n_wb):
    Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen = _fused_step_inputs(
        cuda, c, S, n_wb, n_pad=1024, dpp=64)
    tk.reset_launches()
    Wb = W.to(torch.bfloat16)
    G = tk.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S)
    ref = tk.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S)
    assert _rel(G, ref) < TOL

    W0, Wp0 = W.clone(), Wp.clone()
    want = tk.packed_nesterov_step_reference(
        Ab, W, Wp, y2, WSP, 3.0, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0)
    got = tk.packed_nesterov_step(
        Ab, W, Wp, y2, WSP, 3.0, done, step, Cb, maxit, pen, c=c, S=S, lam=1.0)
    torch.cuda.synchronize()
    assert got[0] is W and got[1] is Wp  # updated in place
    for g, r in zip(got, want):
        assert _rel(g, r) < TOL
    frozen = ~(((3.0 < maxit) & (done == 0)).repeat(1, c))[:, None, :].expand_as(W0)
    assert torch.equal(got[0][frozen], W0[frozen])
    assert torch.equal(got[1][frozen], Wp0[frozen])
    assert tk.LAUNCHES["packed_softmax_grad"] == 1
    assert tk.LAUNCHES["packed_nesterov_step"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("c,dpp,S,n_wb", [
    (2, 64, 3, 1), (3, 64, 6, 2), (7, 64, 6, 2), (16, 64, 2, 1),  # 16 classes: L 8
    (2, 512, 2, 1),   # eight feature atoms, one ring stage
    (5, 144, 3, 1),   # features past the last atom's 64, L 8
])
def test_fused_step_matches_plain_and_repeats_bit_for_bit_on_card(cuda, c, dpp, S, n_wb):
    """B2 (wgmma, TMA ring) within TOL of its plain version, frozen columns
    (done / past max_iter) unmoved, two launches on the same inputs equal
    to the bit, and equal to the bit to B1's gradient run through B2's
    epilogue (the same chain over the rows and the same softmax). The
    match also checks the kernel's claim that, in wgmma's accumulator
    layout, a thread holds every class of its lanes: a wrong grouping would
    give a wrong softmax. 1,216 rows: nine 128-row tiles and a half one."""
    Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen = _fused_step_inputs(
        cuda, c, S, n_wb, n_pad=19 * 64, dpp=dpp, seed=c + dpp)
    geo = tk.step_geometry(dpp, c)
    assert geo is not None and geo["stages"] >= 1
    args = (y2, WSP, 3.0, done, step, Cb, maxit, pen)
    want = tk.packed_nesterov_step_reference(Ab, W, Wp, *args, c=c, S=S, lam=1.0)
    runs = []
    for _ in range(2):
        Wk, Wpk = W.clone(), Wp.clone()
        runs.append(tk.packed_nesterov_step(Ab, Wk, Wpk, *args, c=c, S=S, lam=1.0))
    torch.cuda.synchronize()
    for g, r in zip(runs[0], want):
        assert _rel(g, r) < TOL
    frozen = ~(((3.0 < maxit) & (done == 0)).repeat(1, c))[:, None, :].expand_as(W)
    assert torch.equal(runs[0][0][frozen], W[frozen])
    assert torch.equal(runs[0][1][frozen], Wp[frozen])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    via_b1 = kc.step_via_gradient(tk, Ab, W, Wp, *args, c=c, S=S, lam=1.0)
    for a, b in zip(runs[0], via_b1):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_masked_kernel_matches_plain_on_card(cuda):
    rng = np.random.RandomState(1)
    n_pad, dpp, cp, c, lanes = 2048, 896, 16, 10, 4
    Ab = torch.as_tensor(rng.randn(n_pad, dpp).astype(np.float32)).to(cuda, torch.bfloat16)
    W = torch.as_tensor((rng.randn(lanes, dpp, cp) * 0.05).astype(np.float32))
    W[:, :, c:] = 0
    W = W.to(cuda, torch.bfloat16)
    y2 = torch.as_tensor(rng.randint(0, c, (n_pad, 1)).astype(np.int32)).to(cuda)
    wm = torch.as_tensor((rng.rand(n_pad, lanes) > 0.3).astype(np.float32)).to(cuda)
    got = tk.masked_softmax_grad(Ab, W, y2, wm, c=c)
    ref = tk.masked_softmax_grad_reference(Ab, W, y2, wm, c=c)
    torch.cuda.synchronize()
    assert _rel(got, ref) < TOL
    assert float(got[:, :, c:].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("c,dpp,S,n_wb", [
    (2, 64, 3, 1), (3, 64, 6, 2), (7, 64, 6, 2), (16, 64, 2, 1), (5, 144, 3, 1),
])
def test_packed_softmax_grad_repeats_bit_for_bit_on_card(cuda, c, dpp, S, n_wb):
    """B1 (B2's body with the gradient epilogue) within TOL of its plain
    version and equal to the bit across two launches."""
    Ab, W, _, y2, WSP, *_ = _fused_step_inputs(cuda, c, S, n_wb, n_pad=19 * 64, dpp=dpp,
                                               seed=c + dpp)
    Wb = W.to(torch.bfloat16)
    tk.reset_launches()
    runs = [tk.packed_softmax_grad(Ab, Wb, y2, WSP, c=c, S=S) for _ in range(2)]
    ref = tk.packed_softmax_grad_reference(Ab, Wb, y2, WSP, c=c, S=S)
    torch.cuda.synchronize()
    assert _rel(runs[0], ref) < TOL
    assert torch.equal(runs[0], runs[1])
    assert tk.LAUNCHES["packed_softmax_grad"] == 2


def _masked_inputs(dev, n_pad, dpp, cp, c, lanes, seed):
    rng = np.random.RandomState(seed)
    Ab = torch.as_tensor(rng.randn(n_pad, dpp).astype(np.float32)).to(dev, torch.bfloat16)
    W = torch.as_tensor((rng.randn(lanes, dpp, cp) * 0.05).astype(np.float32))
    W[:, :, c:] = 0
    y2 = torch.as_tensor(rng.randint(0, c, (n_pad, 1)).astype(np.int32)).to(dev)
    wm = torch.as_tensor((rng.rand(n_pad, lanes) > 0.3).astype(np.float32)).to(dev)
    return Ab, W.to(dev, torch.bfloat16), y2, wm


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 16, 192])
@pytest.mark.parametrize("dpp", [128, 896, 1152])
@pytest.mark.parametrize("cp", [16, 32])
@pytest.mark.parametrize("c", [2, 10])
def test_masked_kernel_shapes_repeat_bit_for_bit_on_card(cuda, lanes, dpp, c, cp):
    """B3 (two passes, lanes sharing each A tile, rows split into ranges)
    within TOL of its plain version at 1, 16 and 192 lanes, at dpp 128,
    896 and 1,152 (above the first design's cap), 2 and 10 classes in 16
    or 32 columns; two launches equal to the bit; padded classes exactly 0.
    2,000 rows: the last 128-row tile is partial."""
    Ab, W, y2, wm = _masked_inputs(cuda, 2000, dpp, cp, c, lanes, seed=lanes + dpp + cp)
    tk.reset_launches()
    runs = [tk.masked_softmax_grad(Ab, W, y2, wm, c=c) for _ in range(2)]
    ref = tk.masked_softmax_grad_reference(Ab, W, y2, wm, c=c)
    torch.cuda.synchronize()
    assert _rel(runs[0], ref) < TOL
    assert torch.equal(runs[0], runs[1])
    assert float(runs[0][:, :, c:].abs().max()) == 0.0
    assert tk.LAUNCHES["masked_softmax_grad"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad,dpp,cp,c,lanes", [
    (64, 16, 16, 2, 1),        # one partial atom, one row tile
    (300, 80, 16, 3, 5),       # a partial second atom
    (1000, 192, 48, 40, 3),    # an odd atom count (warpgroup 1 idle in the last block), cp 48
    (700, 208, 160, 150, 2),   # 256 columns a lane (pass (a) at 256 columns)
    (4500, 1040, 32, 20, 7),   # past the first design's dpp cap, a partial atom
])
def test_masked_kernel_ragged_shapes_on_card(cuda, n_pad, dpp, cp, c, lanes):
    """B3 at shapes the gate accepts off the search path's grid: features
    not a multiple of 64 or of 128, classes padded within a lane, and the
    widest lanes; within TOL of its plain version, two launches equal to
    the bit, padded classes exactly 0."""
    Ab, W, y2, wm = _masked_inputs(cuda, n_pad, dpp, cp, c, lanes, seed=dpp + cp)
    runs = [tk.masked_softmax_grad(Ab, W, y2, wm, c=c) for _ in range(2)]
    ref = tk.masked_softmax_grad_reference(Ab, W, y2, wm, c=c)
    torch.cuda.synchronize()
    assert _rel(runs[0], ref) < TOL
    assert torch.equal(runs[0], runs[1])
    assert float(runs[0][:, :, c:].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n_pad", [4096, 100_000])
def test_masked_kernel_many_lanes_at_narrow_dpp_on_card(cuda, n_pad):
    """B3 at a scored covertype search's lane count: 1,536 lanes at dpp 128,
    7 classes in 16 columns. At 100,000 rows R^T holds 24,576 x 100,096
    bf16 (2.46e9 elements, past 2^31), so the last lanes' columns sit at
    offsets only 64-bit arithmetic reaches. The first and the last 64
    lanes against the plain version, two launches equal to the bit."""
    lanes, dpp, cp, c = 1536, 128, 16, 7
    Ab, W, y2, wm = _masked_inputs(cuda, n_pad, dpp, cp, c, lanes, seed=n_pad % 997)
    runs = [tk.masked_softmax_grad(Ab, W, y2, wm, c=c) for _ in range(2)]
    for sl in (slice(0, 64), slice(lanes - 64, lanes)):
        ref = tk.masked_softmax_grad_reference(Ab, W[sl], y2, wm[:, sl].contiguous(), c=c)
        assert _rel(runs[0][sl], ref) < TOL
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert float(runs[0][:, :, c:].abs().max()) == 0.0


@pytest.mark.gpu
def test_masked_kernel_at_the_refit_shape_on_card(cuda):
    """B3 at one lane at the winner's covertype refit (n_pad 116,224, dpp
    128 of which 55 columns are real, 7 classes in 16): within TOL of its
    plain version, two launches equal to the bit, padding exactly 0."""
    lanes, n_pad, dpp, cp, c = kc.MASKED_REFIT_SHAPE
    gen = torch.Generator(device=cuda).manual_seed(10)
    Ab, W, y2, wm = kc.masked_inputs(gen, cuda, lanes, n_pad, dpp, cp, c,
                                     dp=kc.MASKED_SCORED_DP)
    runs = [tk.masked_softmax_grad(Ab, W, y2, wm, c=c) for _ in range(2)]
    ref = tk.masked_softmax_grad_reference(Ab, W, y2, wm, c=c)
    torch.cuda.synchronize()
    assert _rel(runs[0], ref) < TOL
    assert torch.equal(runs[0], runs[1])
    assert float(runs[0][:, :, c:].abs().max()) == 0.0
    assert float(runs[0][:, kc.MASKED_SCORED_DP:].abs().max()) == 0.0


@pytest.mark.gpu
def test_logreg_refit_takes_the_masked_lane_kernel_on_card(cuda):
    """A nesterov refit (fit_single) on the card launches B3 once a solver
    step, at one lane, and never B1 or B2; its predictions on the card are
    the CPU refit's within one eval row in a hundred."""
    from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import fit_single
    from cs230_distributed_machine_learning_tpu_torch.runtime.artifacts import (
        predict_with_artifact,
    )

    rng = np.random.RandomState(3)
    X = rng.randn(12_000, 54).astype(np.float32)
    y = np.argmax(X[:, :7] + 0.5 * rng.randn(12_000, 7), axis=1).astype(np.int32)
    data = TrialData(X, y, 7)
    plan = build_split_plan(y, task="classification", n_folds=0, random_state=42)
    kernel = get_kernel("LogisticRegression")
    params = {"C": 1.0, "max_iter": 40}
    tk.reset_launches()
    card, static = fit_single(kernel, data, plan, params, device=cuda)
    assert static["_method"] == "nesterov"
    assert tk.LAUNCHES == {**tk.LAUNCHES, "masked_softmax_grad": 40, "packed_softmax_grad": 0,
                           "packed_nesterov_step": 0}
    host, _ = fit_single(kernel, data, plan, params, device=torch.device("cpu"))
    ev = plan.eval_w[0] > 0
    art = {"model_type": kernel.name, "parameters": params, "static": static}
    a = predict_with_artifact({**art, "fitted_params": card}, X).cpu().numpy()[ev]
    b = predict_with_artifact({**art, "fitted_params": host}, X, device="cpu").numpy()[ev]
    assert float(np.mean(a != b)) <= 1e-2


@pytest.mark.gpu
def test_masked_plan_matches_the_library(cuda):
    """The Python plan of B3 is the C entry's, field for field."""
    import ctypes

    lib = tk._lib()
    out = (ctypes.c_longlong * len(tk.MASKED_PLAN_FIELDS))()
    for shape in ((4096, 896, 16, 16), (60_160, 896, 16, 192), (2000, 1152, 32, 1),
                  (512, 128, 128, 3), (4096, 896, 160, 16), (256, 16, 256, 2)):
        assert lib.logreg_masked_plan(*shape, out) == 1, shape
        plan = tk.masked_plan(*shape)
        assert list(out) == [plan[k] for k in tk.MASKED_PLAN_FIELDS], shape
    assert lib.logreg_masked_plan(4096, 896, 272, 16, out) == 0
    assert tk.masked_plan(4096, 896, 272, 16) is None


@pytest.mark.gpu
def test_masked_kernel_raises_instead_of_falling_back(cuda):
    """A shape or an input the C entry refuses is an error on the card,
    never the plain version."""
    Ab, W, y2, wm = _masked_inputs(cuda, 512, 128, 16, 10, 4, seed=3)
    tk.reset_launches()
    with pytest.raises(ValueError):  # 272 classes: past the kernel's 256
        Wwide = torch.zeros(4, 128, 272, dtype=torch.bfloat16, device=cuda)
        tk.masked_softmax_grad(Ab, Wwide, y2, wm, c=10)
    with pytest.raises(TypeError):
        tk.masked_softmax_grad(Ab.float(), W, y2, wm, c=10)
    with pytest.raises(ValueError):
        tk.masked_softmax_grad(Ab, W, y2, wm.cpu(), c=10)
    assert tk.LAUNCHES["masked_softmax_grad"] == 0
    # the C entry refuses a row split that is not its plan's
    plan = tk.masked_plan(512, 128, 16, 4)
    G = torch.empty(4, 128, 16, device=cuda)
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError):
        tk._launch(tk._lib().logreg_masked_softmax_grad, tk._ptr(Ab), tk._ptr(W), tk._ptr(y2),
                   tk._ptr(wm), tk._ptr(G), tk._ptr(scratch), plan["scratch"], 512, 128, 16,
                   10, 4, plan["ranges"] + 1, device=Ab.device)


@pytest.mark.gpu
def test_card_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel cannot take is an error, never a silent
    plain-version computation."""
    Ab, W, _, y2, WSP, *_ = _fused_step_inputs(cuda, 4, 3, 1, n_pad=256, dpp=64)
    tk.reset_launches()
    with pytest.raises(TypeError):
        tk.packed_softmax_grad(Ab.float(), W.to(torch.bfloat16), y2, WSP, c=4, S=3)
    with pytest.raises(ValueError):
        tk.packed_softmax_grad(Ab, W.to(torch.bfloat16), y2, WSP.cpu(), c=4, S=3)
    assert tk.LAUNCHES == {k: 0 for k in tk.LAUNCHES}


def _hist_inputs(dev, L, n, d, n_bins, n_nodes, kk, float_stats, seed=0):
    rng = np.random.RandomState(seed)
    local = torch.as_tensor(rng.randint(-1, n_nodes + 1, (L, n)).astype(np.int32)).to(dev)
    xb = torch.as_tensor(rng.randint(0, n_bins, (n, d)).astype(np.int32)).to(dev)
    if float_stats:
        SC = rng.randn(L, n, kk).astype(np.float32)
    else:  # one-hot classes times small bootstrap counts, many zero rows
        SC = (np.eye(kk, dtype=np.float32)[rng.randint(0, kk, (L, n))]
              * rng.poisson(0.8, (L, n, 1)).astype(np.float32))
    return local, xb, torch.as_tensor(SC).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("L,n,d,n_bins,n_nodes,kk", [
    (6, 11_620, 54, 24, 128, 7),    # the 10 % covertype job's deep levels
    (6, 11_620, 54, 48, 1, 7),      # its root
    (3, 4097, 12, 24, 70, 8),       # a node block straddled
    (2, 513, 5, 256, 130, 16),      # the widest bins and stats
])
def test_level_histogram_matches_plain_on_card(cuda, L, n, d, n_bins, n_nodes, kk):
    th.reset_launches()
    local, xb, SC = _hist_inputs(cuda, L, n, d, n_bins, n_nodes, kk, float_stats=False)
    got = th.level_histogram(local, xb, SC, n_nodes, n_bins, integer_stats=True)
    want = th.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    local, xb, SC = _hist_inputs(cuda, L, n, d, n_bins, n_nodes, kk, float_stats=True)
    got = th.level_histogram(local, xb, SC, n_nodes, n_bins)
    want = th.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-5
    assert th.LAUNCHES["level_histogram"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(kc.HIST_FLOAT_SHAPES))
def test_level_histogram_float_stats_at_boosting_shapes_on_card(cuda, tag):
    """B4's float mode at the boosting levels (gradient and hessian
    columns, every live row at the root or the left children of a level):
    within 1e-5 of the plain version's max, one launch a call. Two launches
    may differ in the last bits (f32 atomics in any order)."""
    L, n, d, n_bins, n_nodes, kk = kc.HIST_FLOAT_SHAPES[tag]
    gen = torch.Generator(device=cuda).manual_seed(0)
    local, xb, SC = kc.gb_hist_inputs(gen, cuda, L, n, d, n_bins, n_nodes)
    th.reset_launches()
    got = th.level_histogram(local, xb, SC, n_nodes, n_bins)
    want = th.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert got.shape == (L, n_nodes, d, n_bins, kk)
    assert _rel(got, want) < 1e-5
    assert th.LAUNCHES["level_histogram"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [k for k in kc.SKEWED_LEVELS if k != "uniform"])
@pytest.mark.parametrize("L,n,d,n_bins,n_nodes,kk", [
    (6, 11_620, 54, 24, 128, 7),    # rf_main's deep levels
    (6, 116_202, 54, 16, 1536, 7),  # rf_full's widest level
])
def test_level_histogram_skewed_levels_bit_exact_on_card(cuda, kind, L, n, d, n_bins,
                                                         n_nodes, kk):
    """Nodes of very uneven size (every row in one node, empty nodes, no
    live row, geometric sizes): the bucketed pages still give the plain
    version's histogram to the bit."""
    rng = np.random.RandomState(n_nodes)
    _, xb, SC = _hist_inputs(cuda, L, n, d, n_bins, n_nodes, kk, float_stats=False)
    local = kc.skewed_node_ids(kind, L, n, n_nodes, rng).astype(np.int32)
    local = torch.as_tensor(local).to(cuda)
    th.reset_launches()
    got = th.level_histogram(local, xb, SC, n_nodes, n_bins, integer_stats=True)
    want = th.level_histogram_reference(local, xb, SC, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert th.LAUNCHES["level_histogram"] == 1


@pytest.mark.gpu
def test_level_histogram_raises_instead_of_falling_back(cuda):
    local, xb, SC = _hist_inputs(cuda, 2, 300, 4, 8, 5, 3, float_stats=False)
    th.reset_launches()
    with pytest.raises(TypeError):
        th.level_histogram(local.long(), xb, SC, 5, 8, integer_stats=True)
    with pytest.raises(ValueError):
        th.level_histogram(local, xb, SC, 5, 512, integer_stats=True)  # bins past 256
    with pytest.raises(ValueError):
        th.level_histogram(local, xb.cpu(), SC, 5, 8, integer_stats=True)
    assert th.LAUNCHES["level_histogram"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["scatter", "matmul"])
def test_plain_hist_valve_raises_on_card(cuda, mode, monkeypatch):
    """The reference's plain-form names do not move card tensors off B4."""
    from cs230_distributed_machine_learning_tpu_torch.ops import trees as tt

    local, xb, SC = _hist_inputs(cuda, 2, 300, 4, 8, 5, 3, float_stats=False)
    th.reset_launches()
    monkeypatch.setenv("CS230_HIST_KERNEL", mode)
    with pytest.raises(ValueError):
        tt._level_histogram_multi(local, (xb,), SC, 5, (8,), integer_stats=True)
    assert th.LAUNCHES["level_histogram"] == 0


def _epoch_inputs(dev, dims, bs, nb, L, classification, solver, track, seed=0, ragged=0):
    """Glorot-scale params, small moments, shuffled rows and split weights
    (``ragged`` trailing slots of every batch at zero weight)."""
    rng = np.random.RandomState(seed)
    R = nb * bs
    X = torch.as_tensor(rng.randn(R, dims[0]).astype(np.float32)).to(dev).to(torch.bfloat16)
    if classification:
        Y = np.eye(dims[-1], dtype=np.float32)[rng.randint(0, dims[-1], R)]
    else:
        Y = rng.randn(R, 1).astype(np.float32)
    Wl = (rng.rand(nb, bs, L) > 0.3).astype(np.float32)
    if ragged:
        Wl[:, bs - ragged:, :] = 0.0
    lr = np.full(L, 1e-3, np.float32)
    alpha = (10 ** rng.uniform(-5, -3, L)).astype(np.float32)
    state = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = np.sqrt(6.0 / (din + dout))
        state += [rng.uniform(-bound, bound, (L, din, dout)), np.zeros((L, dout))]
        for _ in range(tm.per_layer(solver) // 2 - 1):
            state += [np.abs(rng.randn(L, din, dout)) * 1e-4, np.abs(rng.randn(L, dout)) * 1e-4]
    if track:
        state.append(np.zeros(L))
    t = [torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in state]
    return (X, torch.as_tensor(Y).to(dev), torch.as_tensor(Wl.reshape(R, L)).to(dev),
            torch.as_tensor(lr).to(dev), torch.as_tensor(alpha).to(dev), t)


@pytest.mark.gpu
@pytest.mark.parametrize("dims,act,bs,nb,L,cls,solver,nest,track,ragged", [
    ((784, 512, 10), "relu", 256, 4, 6, True, "adam", True, False, 0),    # config 5
    ((784, 256, 128, 10), "relu", 128, 4, 6, True, "adam", True, False, 0),
    ((20, 32, 16, 8, 5), "tanh", 64, 3, 5, True, "adam", True, True, 7),
    ((20, 32, 1), "logistic", 40, 3, 4, False, "sgd", False, True, 0),
    ((33, 24, 24, 3), "identity", 50, 3, 3, True, "sgd", True, True, 3),
])
def test_mlp_epoch_matches_plain_on_card(cuda, dims, act, bs, nb, L, cls, solver, nest,
                                          track, ragged):
    X, Y, Wl, lr, alpha, state = _epoch_inputs(cuda, dims, bs, nb, L, cls, solver, track,
                                               ragged=ragged)
    kw = dict(dims=dims, act=act, bs=bs, n_batches=nb, classification=cls, solver=solver,
              nesterov=nest, track_loss=track)
    p0 = [s.clone() for s in state]
    ref = tm.epoch_reference(X, Y, Wl, lr, alpha, 7, [s.clone() for s in state], **kw)
    tm.reset_launches()
    got = tm.epoch(X, Y, Wl, lr, alpha, 7, state, **kw)
    torch.cuda.synchronize()
    assert tm.LAUNCHES["mlp_epoch"] == 1
    k = tm.per_layer(solver)
    for i, (g, r, a) in enumerate(zip(got, ref, p0)):
        if solver == "sgd" or i == len(got) - 1 and track:
            assert _rel(g, r) < 5e-3, i
            continue
        if i % k < 2:  # params
            assert _rel(g, r) < 5e-2, i
        moved = float((r - a).abs().mean())
        assert float((g - r).abs().mean()) <= 1e-2 * moved, i


@pytest.mark.gpu
@pytest.mark.parametrize("tag", ["784-512-10", "784-256-128-10"])
def test_mlp_one_step_within_smoke_limits_on_card(cuda, tag):
    """One step of B5 at the smoke test's MLP_SHAPES on its 72 lanes, from
    the Glorot init at the lanes' own learning rates, held to its
    MLP_LIMITS for a step under Adam and SGD (ops/kernel_cases.py), with
    and without the loss accumulator (MLP_LOSS_LIMIT; the params the same
    to the bit either way)."""
    dims, bs, _ = kc.MLP_SHAPES[tag]
    gen = torch.Generator(device=cuda).manual_seed(5)
    X, Y, Wl, lr, alpha, params = kc.mlp_inputs(gen, cuda, dims, bs, 1, kc.MLP_LANES)
    kw = dict(dims=dims, act="relu", bs=bs, classification=True, n_batches=1)
    tm.reset_launches()
    for solver in ("adam", "sgd"):
        for track_loss in (False, True):
            got = kc.mlp_check(tm, (X, Y, Wl, lr, alpha), params, kc.MLP_LANES, solver, kw,
                               track_loss=track_loss)
            for metric, limit in kc.MLP_LIMITS[("step", solver)].items():
                assert got[metric] < limit, (solver, metric, got[metric])
            if track_loss:
                assert got["loss_rel"] < kc.MLP_LOSS_LIMIT, (solver, got["loss_rel"])
                assert got["untracked_param_abs"] == 0.0, (solver, got)
    assert tm.LAUNCHES["mlp_epoch"] == 2 + 2 * 2


@pytest.mark.gpu
def test_mlp_epoch_raises_instead_of_falling_back(cuda):
    dims = (8, 16, 3)
    X, Y, Wl, lr, alpha, state = _epoch_inputs(cuda, dims, 32, 2, 2, True, "adam", False)
    kw = dict(dims=dims, act="relu", bs=32, n_batches=2, classification=True)
    tm.reset_launches()
    with pytest.raises(TypeError):  # f32 rows: the kernel takes bf16 only
        tm.epoch(X.float(), Y, Wl, lr, alpha, 0, state, **kw)
    with pytest.raises(ValueError):
        tm.epoch(X, Y, Wl.cpu(), lr, alpha, 0, state, **kw)
    with pytest.raises(ValueError):
        tm.epoch(X, Y, Wl, lr, alpha, 0, state, **{**kw, "act": "softplus"})
    assert tm.LAUNCHES["mlp_epoch"] == 0


def _knn_check(Q, X, W, k):
    """B6 against its plain version asked for k + 1 neighbours: (distance
    error, tolerance, rows whose k-th and (k+1)-th neighbours are closer
    than the tolerance)."""
    got_d, got_i = tn.knn_topk(Q, X, W, k)
    ref_d, ref_i = tn.knn_topk_reference(Q, X, W, k + 1)
    torch.cuda.synchronize()
    tol = 1e-5 * float((Q * Q).sum(1).max() + (X * X).sum(1).max())
    clear = (ref_d[..., k] - ref_d[..., k - 1]) > tol
    same = (torch.sort(got_i, -1).values == torch.sort(ref_i[..., :k], -1).values).all(-1)
    assert bool(same[clear].all())
    return float((got_d - ref_d[..., :k]).abs().max()), tol, int((~clear).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,d,L,k", [
    (257, 2049, 6, 3, 3),     # off the tile grid
    (130, 1000, 130, 2, 7),   # features over three staged chunks
    (4096, 20000, 54, 6, 25),  # the search path's query chunk and width
    (64, 500, 54, 1, 256),    # the largest k with lists in shared memory
    (300, 5000, 54, 3, 300),  # lists in device memory
])
def test_knn_topk_matches_plain_on_card(cuda, nq, n, d, L, k):
    rng = np.random.RandomState(nq + k)
    Q = torch.as_tensor(rng.randn(nq, d).astype(np.float32)).to(cuda)
    X = torch.as_tensor(rng.randn(n, d).astype(np.float32)).to(cuda)
    W = torch.as_tensor((rng.rand(L, n) > 0.3).astype(np.float32)).to(cuda)
    tn.reset_launches()
    err, tol, _ = _knn_check(Q, X, W, k)
    assert err <= tol
    assert tn.LAUNCHES["knn_topk"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 6, 9])
@pytest.mark.parametrize("k", [5, 25, 256, 300])
def test_knn_topk_lane_groups_and_row_ranges_bit_equal_on_card(cuda, L, k):
    """Lanes sharing each distance tile (the plan's lane group) and the
    rows split into ranges (n = 9,001 is not a multiple of the range split
    or of the tile) give the plain version's output to the bit on integer
    data: exact distances, exact ties (every row twice, lowest index
    first) and a lane with fewer masked-in rows than k (empty slots)."""
    rng = np.random.RandomState(L * 1000 + k)
    half = rng.randint(-3, 4, (4500, 8)).astype(np.float32)
    X = torch.as_tensor(np.concatenate([half, half, half[:1]])).to(cuda)
    Q = torch.as_tensor(rng.randint(-3, 4, (200, 8)).astype(np.float32)).to(cuda)
    W = torch.as_tensor((rng.rand(L, X.shape[0]) > 0.3).astype(np.float32)).to(cuda)
    W[L - 1] = 0.0
    W[L - 1, [5, 4600, 9000]] = 1.0
    plan = tn.knn_plan(Q.shape[0], X.shape[0], L, k)
    assert plan["ranges"] > 1 and X.shape[0] % plan["ranges"]
    tn.reset_launches()
    got = tn.knn_topk(Q, X, W, k)
    ref = tn.knn_topk_reference(Q, X, W, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), plan
    assert bool((got[1][L - 1, :, 3:] == -1).all())
    assert tn.LAUNCHES["knn_topk"] == 1


@pytest.mark.gpu
def test_knn_topk_exact_ties_and_empty_slots_on_card(cuda):
    rng = np.random.RandomState(11)
    half = rng.randint(-3, 4, (300, 7)).astype(np.float32)
    X = torch.as_tensor(np.concatenate([half, half])).to(cuda)  # every row twice
    Q = torch.as_tensor(rng.randint(-3, 4, (200, 7)).astype(np.float32)).to(cuda)
    W = torch.as_tensor((rng.rand(3, 600) > 0.3).astype(np.float32)).to(cuda)
    W[1] = 0.0
    W[1, [5, 400, 599]] = 1.0  # fewer masked-in rows than k
    for k in (5, 25, tn.SHARED_LISTS_MAX_K, 300, 590):
        got = tn.knn_topk(Q, X, W, k)
        ref = tn.knn_topk_reference(Q, X, W, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), k
        assert bool((got[1][1, :, 3:] == -1).all())
        assert bool((got[0][1, :, 3:] == np.float32(tn.INF)).all())


@pytest.mark.gpu
def test_knn_topk_raises_instead_of_falling_back(cuda):
    Q = torch.randn(16, 5, device=cuda)
    X = torch.randn(100, 5, device=cuda)
    W = torch.ones(2, 100, device=cuda)
    tn.reset_launches()
    with pytest.raises(ValueError):  # no k below one
        tn.knn_topk(Q, X, W, 0)
    with pytest.raises(TypeError):
        tn.knn_topk(Q.double(), X, W, 5)
    with pytest.raises(ValueError):
        tn.knn_topk(Q, X.t().contiguous().t(), W, 5)  # not contiguous
    with pytest.raises(ValueError):
        tn.knn_topk(Q, X, W.cpu(), 5)
    assert tn.LAUNCHES["knn_topk"] == 0


@pytest.mark.gpu
def test_knn_topk_above_256_launches_on_card(cuda):
    """A k above the shared-memory lists' limit no longer raises: the lists
    move to device memory and the result equals the plain version's."""
    rng = np.random.RandomState(13)
    X = torch.as_tensor(rng.randint(-4, 5, (3000, 9)).astype(np.float32)).to(cuda)
    Q = torch.as_tensor(rng.randint(-4, 5, (150, 9)).astype(np.float32)).to(cuda)
    W = torch.as_tensor((rng.rand(2, 3000) > 0.2).astype(np.float32)).to(cuda)
    tn.reset_launches()
    got = tn.knn_topk(Q, X, W, 300)
    ref = tn.knn_topk_reference(Q, X, W, 300)
    torch.cuda.synchronize()
    assert tn.knn_list_mode(300) == "device"
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert tn.LAUNCHES["knn_topk"] == 1


@pytest.mark.gpu
def test_knn_topk_at_the_artifact_predict_shape_on_card(cuda):
    """B6 at one lane at the KNN winner's prediction on its holdout: the
    40,000 eval rows as queries against 200,000 training rows (the split's
    160,000 masked in), k 5; the plain version asked for k + 1 decides
    which rows' neighbour sets are clear of a tie."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    X = torch.randn(200_000, 54, generator=gen, device=cuda)
    Q = X[:kc.KNN_PREDICT_QUERIES].contiguous()
    W = (torch.rand(1, 200_000, generator=gen, device=cuda) > 0.2).float()
    tn.reset_launches()
    err, tol, _ = _knn_check(Q, X, W, 5)
    assert err <= tol
    assert tn.LAUNCHES["knn_topk"] == 1


def _rung_reports(manager):
    """{trial index: [(rung, score), ...]} of the journaled rung reports and
    {trial index: final status} of a finished adaptive-search job."""
    job = manager._coordinator.store.get_job(manager.session_id, manager.job_id)
    reports, final = {}, {}
    for stid, sub in job["subtasks"].items():
        i = int(stid.rsplit("-", 1)[1])
        reports[i] = [(h["rung"], h["score"]) for h in sub.get("rung_history") or []
                      if h.get("report")]
        final[i] = sub["status"]
    return reports, final


def _close_cut(reports, tol):
    """True where a trial promoted out of a rung and one stopped there lie
    within ``tol`` of each other (and are not exactly tied)."""
    by_rung = {}
    for i, reps in reports.items():
        for rung, score in reps:
            by_rung.setdefault(rung, {})[i] = score
    for rung, scores in by_rung.items():
        up = {i for i in scores if i in by_rung.get(rung + 1, {})}
        if any(0.0 < abs(scores[p] - scores[q]) <= tol
               for p in up for q in set(scores) - up):
            return True
    return False


@pytest.mark.gpu
def test_asha_logreg_job_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """A small ASHA LogReg search through the manager on the card (every
    rung wave on the fused step, B2) and on the CPU (its plain version,
    forced onto the same packed path): each (trial, rung) score within
    2e-3, and the same rung decisions wherever no cut has two peers within
    2e-3. At 20,000 x 54 x 7 the solver is nesterov (n * dp * c past the
    Newton workspace) and the packed gate takes dpp 64, c 7."""
    from scipy.stats import loguniform

    from cs230_distributed_machine_learning_tpu_torch import MLTaskManager
    from cs230_distributed_machine_learning_tpu_torch.utils import config as tcfg

    monkeypatch.setenv("CS230_FORCE_PACKED", "1")
    cfg = tcfg.FrameworkConfig.load(env={})
    cfg.storage.root = str(tmp_path)
    tcfg.set_config(cfg)
    job = {"model_type": "LogisticRegression", "search_type": "RandomizedSearchCV",
           "base_estimator_params": {"max_iter": 45},
           "param_distributions": {"C": loguniform(1e-3, 1e2), "tol": [1e-4, 1e-3]},
           "n_iter": 27, "random_state": 0, "cv_params": {"cv": 3}}
    asha = {"type": "asha", "eta": 3}
    try:
        tk.reset_launches()
        card = MLTaskManager(device=cuda)
        cs = card.train(job, "synthetic_20000x54x7", {"random_state": 42},
                        search_params=asha, show_progress=False)
        launches = dict(tk.LAUNCHES)
        host = MLTaskManager(device="cpu")
        hs = host.train(job, "synthetic_20000x54x7", {"random_state": 42},
                        search_params=asha, show_progress=False)
    finally:
        tcfg.set_config(tcfg.FrameworkConfig.load(env={}))
    assert cs["job_status"] == hs["job_status"] == "completed"
    assert cs["job_result"]["failed"] == [] and hs["job_result"]["failed"] == []
    # rung waves of 27, 9 and 3 trials at 5, 15 and 45 steps, one block each
    assert launches["packed_nesterov_step"] == 5 + 15 + 45, launches
    crep, cfinal = _rung_reports(card)
    hrep, hfinal = _rung_reports(host)
    for i in crep:
        for (rc, a), (rh, b) in zip(crep[i], hrep[i]):
            if rc == rh:
                assert abs(a - b) <= 2e-3, (i, rc, a, b)
    # the ladder's counts do not depend on which trials climb it
    assert cs["job_result"]["search"] == hs["job_result"]["search"]
    if not _close_cut(hrep, 2e-3):
        assert cfinal == hfinal
        assert [[r for r, _ in crep[i]] for i in sorted(crep)] == \
            [[r for r, _ in hrep[i]] for i in sorted(hrep)]
        assert cs["job_result"]["best_result"]["parameters"] == \
            hs["job_result"]["best_result"]["parameters"]


@pytest.mark.gpu
def test_level_histogram_at_the_streamed_block_shape_on_card(cuda):
    """B4 at chip_smoke's stream_rf widest level: one lane, a block of
    11,574 rows (a 20 MB stage budget's block of covertype's codes), the
    deepest level's 64 left children, 54 features, 128 bins, 7 classes:
    integer stats bit-exact."""
    th.reset_launches()
    local, xb, SC = _hist_inputs(cuda, 1, 11_574, 54, 128, 64, 7, float_stats=False)
    got = th.level_histogram(local, xb, SC, 64, 128, integer_stats=True)
    want = th.level_histogram_reference(local, xb, SC, 64, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert th.LAUNCHES["level_histogram"] == 1


@pytest.mark.gpu
def test_streamed_forest_card_matches_cpu(cuda, monkeypatch):
    """One streamed forest (CS230_STREAM=force, 256-row blocks not
    dividing n) on the card and on the CPU: scores equal to the bit; on
    the card B4 launches once a level block of every (split, tree), the
    blocks staged through the side stream, each device's under its own
    keys."""
    from cs230_distributed_machine_learning_tpu_torch.data import stage_cache as sc
    from cs230_distributed_machine_learning_tpu_torch.models.base import TrialData
    from cs230_distributed_machine_learning_tpu_torch.models.registry import get_kernel
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan
    from cs230_distributed_machine_learning_tpu_torch.parallel.trial_map import run_trials

    monkeypatch.setenv("CS230_STAGE_CACHE", "1")
    monkeypatch.setenv("CS230_STREAM", "force")
    monkeypatch.setenv("CS230_STREAM_BLOCK_ROWS", "256")
    rng = np.random.default_rng(7)
    X = rng.normal(size=(1500, 12)).astype(np.float32)
    y = np.argmax(X[:, :3] + rng.normal(scale=0.5, size=(1500, 3)), 1).astype(np.int32)
    plan = build_split_plan(y, task="classification", n_folds=2)
    kernel = get_kernel("RandomForestClassifier")
    params = [{"n_estimators": 2, "max_depth": 4, "n_bins": 16, "max_features": 4,
               "random_state": 3}]
    sc.STAGE_CACHE.clear()
    try:
        th.reset_launches()
        card = run_trials(kernel, TrialData(X=X, y=y, n_classes=3), plan, params, device=cuda)
        launches = th.LAUNCHES["level_histogram"]
        host = run_trials(kernel, TrialData(X=X, y=y, n_classes=3), plan, params,
                          device=torch.device("cpu"))
        devices = {k[1] for k in sc.STAGE_CACHE.uploads_by_key()}
    finally:
        sc.STAGE_CACHE.clear()
    assert card.trial_metrics == host.trial_metrics
    assert launches == plan.n_splits * 2 * 4 * 6  # splits x trees x depth x blocks
    assert devices == {("cuda", 0), ("cpu", 0)}
