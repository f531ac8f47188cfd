"""The shapes and inputs at which the port's kernels are checked and timed.

``chip_smoke.py`` holds kernels B1-B6 against their plain versions at
these shapes, ``kernel_ab.py`` times two checkouts' kernels on
inputs from the same builders, and the GPU tests reuse them. The module imports
only the standard library, numpy and torch at import time, so that
``kernel_ab.py`` can load it from one checkout while it times the package
of another.
"""

from __future__ import annotations

import hashlib
import math
import statistics
import time

import numpy as np
import torch


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (on the host): equal digests
    mean equal outputs to the bit."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------ B1, B2 (logreg)

#: bench.py's 1000-trial covertype job: (n_pad, dpp, classes, splits,
#: 128-trial weight blocks of one 1024-trial dispatch)
LOGREG_SHAPE = (116_736, 64, 7, 6, 8)
#: the solver step at which the kernels are held and timed
LOGREG_STEP_T = 3.0


def logreg_inputs(gen, dev, n_pad, dpp, c, S, n_wb):
    """The packed kernels' inputs: bf16 rows, labels, split weights (70 %
    in), small f32 W / Wp, a done flag on ~30 % of the lanes, max_iter 2
    (frozen at step 3) on ~half, and a penalty column with the last 10
    features unpenalized."""
    Tw = 128
    B = S * Tw
    NB = c * B
    Ab = torch.randn(n_pad, dpp, generator=gen, device=dev).to(torch.bfloat16)
    y2 = torch.randint(0, c, (n_pad, 1), generator=gen, device=dev, dtype=torch.int32)
    WSP = (torch.rand(n_pad, S, generator=gen, device=dev) > 0.3).float()
    W = torch.randn(n_wb, dpp, NB, generator=gen, device=dev) * 0.05
    Wp = torch.randn(n_wb, dpp, NB, generator=gen, device=dev) * 0.05
    done = (torch.rand(n_wb, B, generator=gen, device=dev) > 0.7).float()
    step = 0.01 + torch.rand(n_wb, B, generator=gen, device=dev) * 0.1
    Cb = 0.1 + torch.rand(n_wb, B, generator=gen, device=dev)
    maxit = torch.where(torch.rand(n_wb, B, generator=gen, device=dev) > 0.5, 100.0, 2.0)
    pen = torch.ones(dpp, 1, device=dev)
    pen[-10:] = 0.0
    return Ab, W, Wp, y2, WSP, done, step, Cb, maxit, pen


def step_via_gradient(R, Ab, W, Wp, y2, WSP, t, done, step, Cb, maxit, pen, *, c, S,
                      lam, Tw=128):
    """The fused step (B2) built from B1 (module ``R``: ``ops/cuda_logreg.py``):
    B1's gradient at the bf16 look-ahead, then B2's epilogue in PyTorch op
    for op (one rounding an operation, as the kernel's ``__f*_rn``).
    Returns new ``(W, Wp, gmax)``; B2 must equal it to the bit."""
    B = S * Tw
    dpp = W.shape[1]
    tt = torch.tensor(t, dtype=torch.float32, device=W.device)
    mom = tt / (tt + 3.0)
    V = W + mom * (W - Wp)
    G = R.packed_softmax_grad(Ab, V.to(torch.bfloat16), y2, WSP, c=c, S=S, Tw=Tw)
    G = Cb.repeat(1, c)[:, None, :] * G + lam * (pen.reshape(1, dpp, 1) * V)
    gmax = G.abs().reshape(W.shape[0], dpp, c, B).amax(dim=(1, 2))
    act = ((tt < maxit) & (done == 0.0)).repeat(1, c)[:, None, :]
    return (torch.where(act, V - step.repeat(1, c)[:, None, :] * G, W),
            torch.where(act, W, Wp), gmax)


# ------------------------------------------------------- B3 (masked logreg)

#: B3 shapes: (lanes, n_pad, dpp, cp, classes). ``wide``: chip_smoke.py's
#: 784-feature search on 4,096 rows (4 trials x 4 splits); ``wide_full``:
#: RandomizedSearchCV(LogisticRegression(), n_iter=32, cv=5) on
#: synthetic_60000x784x10 (32 trials x 6 splits, rows padded to 256s), one
#: dispatch of the generic nesterov driver
MASKED_SHAPES = {"wide": (16, 4096, 896, 16, 10), "wide_full": (192, 60_160, 896, 16, 10)}
#: B3 at a scored covertype search's generic dispatch: 256 trials x 6 splits
#: on 116,202 rows padded to 256, 55 columns to 128, 7 classes to 16. Its R^T
#: scratch holds 24,576 x 116,224 bf16 (2.86e9 elements, past 2^31)
MASKED_SCORED_SHAPE = (1536, 116_224, 128, 16, 7)
#: the real columns of that shape: 54 features and the intercept
MASKED_SCORED_DP = 55
#: B3 at the winner's refit on covertype (runtime/executor.py::fit_artifact):
#: one lane (one trial, the holdout split), the same padded rows and columns
MASKED_REFIT_SHAPE = (1, 116_224, 128, 16, 7)


def masked_inputs(gen, dev, lanes, n_pad, dpp, cp, c, dp=None):
    """B3's inputs: bf16 rows, small bf16 weights with the padded classes
    zero, labels, and per-lane fold masks (70 % in). With ``dp`` < dpp
    the columns from dp on are zero in the rows and the weights, as
    ``models/logistic.py::_make_masked_grad_fn`` pads them."""
    Ab = torch.randn(n_pad, dpp, generator=gen, device=dev).to(torch.bfloat16)
    W = torch.randn(lanes, dpp, cp, generator=gen, device=dev) * 0.02
    W[:, :, c:] = 0
    if dp is not None:
        Ab[:, dp:] = 0
        W[:, dp:] = 0
    y2 = torch.randint(0, c, (n_pad, 1), generator=gen, device=dev, dtype=torch.int32)
    wm = (torch.rand(n_pad, lanes, generator=gen, device=dev) > 0.3).float()
    return Ab, W.to(torch.bfloat16), y2, wm


# --------------------------------------------------------------- B4 (hist)

#: B4 shapes: (L lanes, rows, features, bins, nodes, stat columns)
HIST_SHAPES = {
    "rf_main_deep": (6, 11_620, 54, 24, 128, 7),
    "rf_main_fine": (6, 11_620, 54, 48, 128, 7),
    "rf_full_widest": (6, 116_202, 54, 16, 1536, 7),
    # rf_full's widest level with node sizes from a geometric law (a few
    # nodes hold most rows), as the uneven levels of a real tree do
    "rf_full_skewed": (6, 116_202, 54, 16, 1536, 7),
}
HIST_SKEWED = {"rf_full_skewed"}
#: B4 at the winner's refit of rf_full: one lane (one tree of the holdout
#: split) at the widest level
HIST_REFIT_SHAPES = {"refit_rf_widest": (1, 116_202, 54, 16, 1536, 7)}
#: the geometric law's success probability: the largest node of a level
#: holds a few % of its rows, the smallest one row or none
HIST_SKEW_P = 0.05


def hist_inputs(gen, dev, L, n, d, n_bins, n_nodes, kk, float_stats, skewed=False):
    """Node ids with dead rows (-1 and n_nodes; with ``skewed``, live ids
    drawn with probabilities proportional to geometric node sizes), shared
    codes, and stats: one-hot classes times small bootstrap counts (many
    zero rows), or normal floats."""
    local = torch.randint(-1, n_nodes + 1, (L, n), generator=gen, device=dev,
                          dtype=torch.int32)
    if skewed:
        u = torch.rand(n_nodes, generator=gen, device=dev).clamp_min(1e-12)
        sizes = torch.floor(torch.log(u) / math.log1p(-HIST_SKEW_P)) + 1
        live = torch.multinomial(sizes / sizes.sum(), L * n, replacement=True, generator=gen)
        dead = (local < 0) | (local >= n_nodes)
        local = torch.where(dead, local, live.view(L, n).int())
    xb = torch.randint(0, n_bins, (n, d), generator=gen, device=dev, dtype=torch.int32)
    if float_stats:
        return local, xb, torch.randn(L, n, kk, generator=gen, device=dev)
    y = torch.randint(0, kk, (L, n), generator=gen, device=dev)
    counts = torch.poisson(torch.full((L, n), 0.9, device=dev), generator=gen)
    return local, xb, torch.nn.functional.one_hot(y, kk).float() * counts[..., None]


#: B4's float mode at the boosting levels: (lanes, rows, features, bins,
#: nodes, stat columns). ``gb_main_*``: GridSearchCV(GradientBoosting-
#: Classifier(n_estimators=50), 4 learning rates, cv=5) on the uncut
#: covertype table, 4 trials x 6 splits x 7 class trees folded into lanes,
#: at the root and at the last level's left children (2 nodes);
#: ``gb_titanic``: BASELINE config 4's GradientBoostingRegressor, 2 trials
#: x 6 splits on the preprocessed titanic table, at the root
HIST_FLOAT_SHAPES = {
    "gb_main_root": (168, 116_202, 54, 128, 1, 2),
    "gb_main_l2": (168, 116_202, 54, 128, 2, 2),
    "gb_titanic": (12, 867, 12, 128, 1, 2),
}
#: B4's float mode at the winner's refit of gb_main: one trial on the
#: holdout split, its 7 class trees a stage as lanes, at the root
HIST_FLOAT_REFIT_SHAPES = {"refit_gb_root": (7, 116_202, 54, 128, 1, 2)}


def gb_hist_inputs(gen, dev, L, n, d, n_bins, n_nodes):
    """A boosting level's histogram inputs: log-loss gradients ``y - p`` and
    hessians ``max(p (1 - p), 1e-12)`` of an 80 % subsample (the others add
    a zero gradient and the 1e-12 floor), shared codes, and node ids: the
    root (every row in node 0) or, past it, the left children of a level
    of ``2 * n_nodes`` nodes (ids ``node // 2``, the right children's rows
    with zero stats, as ``build_tree`` calls the kernel)."""
    p = torch.rand(L, n, generator=gen, device=dev)
    y = (torch.rand(L, n, generator=gen, device=dev) < p).float()
    mask = (torch.rand(L, n, generator=gen, device=dev) < 0.8).float()
    SC = torch.stack([(y - p) * mask, torch.clamp(p * (1 - p) * mask, min=1e-12)], dim=-1)
    xb = torch.randint(0, n_bins, (n, d), generator=gen, device=dev, dtype=torch.int32)
    if n_nodes == 1:
        return torch.zeros((L, n), dtype=torch.int32, device=dev), xb, SC
    node = torch.randint(0, 2 * n_nodes, (L, n), generator=gen, device=dev, dtype=torch.int32)
    return node // 2, xb, SC * (node % 2 == 0)[..., None]


#: levels whose nodes hold very uneven row counts
SKEWED_LEVELS = ("uniform", "one_node_all_rows", "empty_nodes", "all_dead", "geometric")


def skewed_node_ids(kind: str, L: int, n: int, n_nodes: int, rng) -> np.ndarray:
    """Node ids [L, n] of one of ``SKEWED_LEVELS`` (dead rows are -1 or
    n_nodes), from a numpy ``RandomState``."""
    if kind == "uniform":
        return rng.randint(-1, n_nodes + 1, (L, n))
    if kind == "one_node_all_rows":
        return np.full((L, n), n_nodes // 2)
    if kind == "empty_nodes":  # only every fifth node holds rows
        return rng.randint(0, -(-n_nodes // 5), (L, n)) * 5
    if kind == "all_dead":
        return np.where(rng.rand(L, n) < 0.5, -1, n_nodes)
    if kind != "geometric":
        raise ValueError(f"unknown level kind {kind!r}")
    p = rng.geometric(HIST_SKEW_P, n_nodes).astype(np.float64)  # a few nodes hold most rows
    return np.stack([rng.choice(n_nodes, n, p=p / p.sum()) for _ in range(L)])


# ---------------------------------------------------------------- B5 (mlp)

#: B5 shapes: (dims, batch size, steps of a full epoch at 60,000 rows)
MLP_SHAPES = {
    "784-512-10": ((784, 512, 10), 256, 234),
    "784-256-128-10": ((784, 256, 128, 10), 128, 468),
}
#: lanes of one config-5 dispatch: 12 trials x 6 splits
MLP_LANES = 72
MLP_CHECK_STEPS = 8
#: the learning rate of the 8-step check: config 5's smallest
MLP_EPOCH_LR = 1e-4
# B5 vs its plain version, from the same state. Both round the same
# operands to bf16 but sum in other orders, so a relu input or a bf16
# rounding (2^-8 relative) within f32 noise of its edge can go either way,
# and Adam turns a gradient within rounding of zero into a step of up to
# the learning rate either way; at config 5's larger learning rates the
# two fits then drift apart within a few steps, as any two summation
# orders would. So the kernel is held after one step at the lanes' own
# learning rates and after an 8-step epoch at MLP_EPOCH_LR, by the largest
# param error over the largest |param| ("param_rel"), the share of params
# more than 1e-3 of the largest |param| apart ("far") and every state
# tensor's mean error over its mean change ("mean"). Measured on the H100
# (NVIDIA H100 80GB HBM3, 700.00 W) at both shapes: SGD rel <= 1.6e-5 and
# mean <= 4.2e-3; Adam far <= 1.5e-6 and mean <= 1.6e-2 after the epoch,
# mean <= 4.3e-6 after one step (where a flipped sign still moves a param
# by 2 lr: rel up to 0.17).
MLP_LIMITS = {
    ("step", "sgd"): {"param_rel": 5e-3, "mean_rel": 2e-2},
    ("step", "adam"): {"param_far_share": 1e-3, "mean_rel": 2e-2},
    ("epoch", "sgd"): {"param_rel": 5e-3, "mean_rel": 2e-2},
    ("epoch", "adam"): {"param_far_share": 1e-2, "mean_rel": 1e-1},
}
# The loss accumulator the fused path runs whenever curves are on: every
# lane's summed batch loss within this share of the plain version's. The
# losses of one step come from the same state and differ only in their
# summation order (f32 rounding, ~1e-6 relative); after the 8-step epoch
# the params have drifted by the shares above. A batch lost or counted
# twice moves an 8-step sum by ~1/8.
MLP_LOSS_LIMIT = 1e-3


def mlp_inputs(gen, dev, dims, bs, steps, L, S=6):
    """An epoch's inputs as the fused path builds them: bf16 rows, one-hot
    targets, the 6 split masks spread over the lanes (lane = trial * 6 +
    split), config-5 learning rates and penalties, and the Glorot params."""
    R = steps * bs
    X = torch.randn(R, dims[0], generator=gen, device=dev).to(torch.bfloat16)
    Y = torch.nn.functional.one_hot(
        torch.randint(0, dims[-1], (R,), generator=gen, device=dev), dims[-1]).float()
    splits = (torch.rand(R, S, generator=gen, device=dev) > 0.2).float()
    Wl = splits[:, torch.arange(L, device=dev) % S].contiguous()
    grid = torch.tensor([1e-4, 3e-4, 1e-3, 3e-3, 1e-2], device=dev)
    lr = grid[torch.randint(0, 5, (L,), generator=gen, device=dev)].contiguous()
    alpha = torch.tensor([1e-5, 1e-4, 1e-3], device=dev)[
        torch.randint(0, 3, (L,), generator=gen, device=dev)].contiguous()
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = (6.0 / (din + dout)) ** 0.5
        params.append({"W": (torch.rand(din, dout, generator=gen, device=dev) * 2 - 1) * bound,
                       "b": torch.zeros(dout, device=dev)})
    return X, Y, Wl, lr, alpha, params


def mlp_check(M, part, params, L, solver, kw, track_loss: bool = False) -> dict:
    """One short epoch of B5 (module ``M``: ``ops/cuda_mlp.py``) against its
    plain version from the same state. Params (every W and b): the largest
    error over the largest |param| ("param_rel") and the share of params
    more than 1e-3 of the largest |param| apart ("param_far_share"); every
    layer's state tensor: its mean error over its mean change ("mean_rel").
    With ``track_loss``, the mode of the fused path while curves are on:
    the accumulated loss's largest error over the lane's |loss|
    ("loss_rel"), and the largest difference of the params from the same
    kernel's epoch without the loss ("untracked_param_abs"; the loss only
    reads what the update uses, so 0.0)."""
    state = M.epoch_state(params, L, solver, track_loss)
    k = M.per_layer(solver)
    kw = dict(kw, track_loss=track_loss)
    ref = M.epoch_reference(*part, 0, [t.clone() for t in state], solver=solver, **kw)
    got = M.epoch(*part, 0, [t.clone() for t in state], solver=solver, **kw)
    if got[0].is_cuda:
        torch.cuda.synchronize()
    n_layer = len(got) - int(track_loss)  # the loss [L] trails the layers' tensors
    pidx = [i for i in range(n_layer) if i % k < 2]  # params: W, b
    scale = max(float(ref[i].abs().max()) for i in pidx)
    out = dict(param_abs=0.0, mean_rel=0.0)
    if track_loss:
        out["loss_rel"] = float(((got[-1] - ref[-1]).abs()
                                 / ref[-1].abs().clamp(min=1e-12)).max())
        bare = M.epoch(*part, 0, [t.clone() for t in state[:n_layer]], solver=solver,
                       **dict(kw, track_loss=False))
        out["untracked_param_abs"] = max(float((got[i] - bare[i]).abs().max()) for i in pidx)
    far = total = 0
    for i, (g, r, a) in enumerate(zip(got[:n_layer], ref, state)):
        assert bool(torch.isfinite(g).all()), f"B5 {solver}: non-finite state {i}"
        if i in pidx:
            out["param_abs"] = max(out["param_abs"], float((g - r).abs().max()))
            far += int(((g - r).abs() > 1e-3 * scale).sum())
            total += g.numel()
        moved = float((r - a).abs().mean())
        if moved > 0:
            out["mean_rel"] = max(out["mean_rel"], float((g - r).abs().mean()) / moved)
    out["param_rel"] = out["param_abs"] / scale
    out["param_far_share"] = far / total
    return out


# ---------------------------------------------------------------- B6 (knn)

#: the KNN slice's table: covertype's width and classes at the first round
#: size above both B6 gates (n >= 150,000 and (S-1)/S n >= 150,000 at S = 6)
KNN_DATASET = "synthetic_200000x54x7"
#: queries of one launch on the search path: a chunk of the table's rows
KNN_QUERIES = 4096
#: the search grid's k, and a k above the shared-memory lists' limit
KNN_GRID_KS = [5, 25]
KNN_DEVICE_LISTS_K = 300
#: queries of the winner artifact's prediction on the holdout rows: one
#: lane (the holdout split's training rows), the 40,000 eval rows
KNN_PREDICT_QUERIES = 40_000


def knn_table(cache, dev) -> tuple:
    """The KNN table on the card from a ``DatasetCache``: (TrialData, X,
    the job's 6 split masks W [6, n], staging seconds)."""
    from cs230_distributed_machine_learning_tpu_torch.ops.folds import build_split_plan

    t0 = time.perf_counter()
    data = cache.get(KNN_DATASET, "classification")
    staged = time.perf_counter() - t0
    assert data.X.shape == (200_000, 54) and data.n_classes == 7, data.X.shape
    plan = build_split_plan(np.asarray(data.y), task="classification", n_folds=5,
                            random_state=42)
    X = torch.as_tensor(np.asarray(data.X, np.float32), device=dev)
    W = torch.as_tensor(plan.train_w, device=dev).float().contiguous()
    return data, X, W, staged
